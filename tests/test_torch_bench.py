"""Port vs reference: the 2D protocol of the port's bench
(``tpu_splatting_torch.bench.make_scene_step``).

``make_scene_step`` gives the reference ``bench_scene``'s two closures
(``map_f``, then ``fwd_bwd`` of the tiled loss with visibility and point
heuristics).  They are held against the same composition written with the
JAX package's ``stream_map``, ``stream_rasterize_with_mapping``, ``entile``,
``tile_mask`` and ``probe_width`` (interpret mode, as tests/conftest.py
sets it), on the same numpy inputs: the bench's uniform and heavy scenes at
2,000 splats, and the uniform one again in the ``depth12`` key layout
(``stream_map(depth_bits=12)``, which the mapper takes past 16,383 tiles;
the ``slow`` test holds a 16,384-tile image, 300 splats, in about 650 s
on the CPU).  The depths are made distinct in their key bits (their
order kept), since sort-key ties order differently on the two sides
(F2).

Held: the mapping's integer fields exactly; the tiled image and every
gradient per column within 1e-4 * max |reference column| + 1e-6, except
the gradients of splats thinner than 0.1 px (31 of the heavy scene's
2,000), which f32 conditions badly (ROADMAP F16: against the port's own
f64 twin, the port's f32 gradient of one such splat errs by 2.8e-4 of the
column's largest, the reference's by 5.2e-5) and which are held at
1e-3 * max + 1e-6, the f32 leaf gate of F8; both sides' thin rows are
also bounded by 1e-3 of the column from that f64 twin.  The scenes run at 128x96 (6
groups of 8 tiles), not 256x192: the reference's interpret-mode forward +
backward takes about 1 s a group here, and one set of capacities shared by
the three cases lets it compile its kernels once.
"""

import dataclasses

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import port_compare as pc  # noqa: E402
from tpu_splatting import RasterConfig as JRasterConfig  # noqa: E402
from tpu_splatting.rasterizer import stream as jstream  # noqa: E402
from tpu_splatting.rasterizer import stream_function as jfun  # noqa: E402
from tpu_splatting_torch import bench as tbench  # noqa: E402
from tpu_splatting_torch.benchmarks.check_card import make_scene  # noqa: E402
from tpu_splatting_torch.rasterizer.stream_function import (  # noqa: E402
    stream_rasterize_with_mapping)

SIZE, N, GW = (128, 96), 2000, 8
THIN = 0.1     # px: splats with a thinner axis are held at 1e-3 (F16)


def distinct_depths(depth, bits):
  """The same depth order, spread over (0.05, 0.95) so that no two points
  share a key's ``bits`` depth bits."""
  n = depth.shape[0]
  assert 0.9 / n > 1.5 / (1 << bits)
  rank = np.argsort(np.argsort(depth, kind="stable"), kind="stable")
  return (0.05 + 0.9 * (rank + 0.5) / n).astype(np.float32)


@pytest.fixture(scope="module")
def scenes():
  """{case: (packed, depth, feats, depth bits)} and the capacities shared
  by every case (the largest of the port's calibrations), so that the
  reference compiles its kernels once."""
  out, caps = {}, {}
  cfg = tbench._trainer_config(GW)
  for case, name, bits in (("uniform", "uniform", 14),
                           ("heavy", "heavy", 14),
                           ("depth12", "uniform", 12)):
    packed, depth, feats = tbench.scene_arrays(name, N, SIZE)
    depth = distinct_depths(depth, bits)
    out[case] = (packed, depth, feats, bits)
    cal = tbench.calibrate_stream(*(torch.from_numpy(x) for x in
                                    (packed, depth, feats)), SIZE, cfg,
                                  group_width=GW)
    for k in (*tbench.MAP_KEYS, "big_tile_window"):
      caps[k] = max(caps.get(k, 0), cal[k])
  return out, caps


def assert_columns_close(got, want, label, loose_rows=None):
  """(rows, columns): each column within 1e-4 * its largest |want| +
  1e-6; the ``loose_rows`` (a boolean mask) within 1e-3 * it + 1e-6."""
  want = np.asarray(want, np.float64)
  err = np.abs(np.asarray(got, np.float64) - want)
  colmax = np.abs(want).max(0)
  tol = np.broadcast_to(1e-4 * colmax + 1e-6, err.shape).copy()
  if loose_rows is not None:
    tol[loose_rows] = 1e-3 * colmax + 1e-6
  assert (err <= tol).all(), (label, (err / tol).max(0).tolist())


def scene_step_vs_reference(packed, depth, feats, size, bits, caps, btw):
  """The bench's closures and the JAX composition on the same inputs:
  the mappings exactly, the tiled image and every gradient per column
  (``assert_columns_close``; splats thinner than ``THIN`` at 1e-3, F16).
  Returns the port's (p, f, tgt, mask, mapping, fwd_bwd, gradients) and
  the reference's gradients."""
  n = packed.shape[0]
  caps = {**caps, "group_width": GW, "depth_bits": bits}

  # the port: the bench's own closures
  tcfg = dataclasses.replace(tbench._trainer_config(GW), big_tile_window=btw)
  map_f, fwd_bwd = tbench.make_scene_step(size, tcfg, caps)
  p, d, f = (torch.from_numpy(x) for x in (packed, depth, feats))
  mt = map_f(p, d, f)
  tgt, mask = tbench.loss_target(size, tcfg.tile_size, "cpu")
  gt = fwd_bwd(p, f, tgt, mask, mt)
  it_t = stream_rasterize_with_mapping(p, f, mt, size, tcfg, tiled=True)
  assert int(mt.num_overflow) == 0 and mt.depth_bits == bits

  # the reference: the same composition from the JAX package
  jcfg = JRasterConfig(compute_point_heuristic=True, compute_visibility=True,
                       stream_group_width=GW, big_tile_window=btw)
  pj, dj, fj = (jnp.asarray(x) for x in (packed, depth, feats))
  mj = jstream.stream_map(pj, dj, fj, size, jcfg, **caps)
  tw, th = mj.tiles_wide, mj.tiles_high
  tgt_j = jfun.entile(jnp.asarray(np.random.default_rng(7).random(
      (size[1], size[0], 3)).astype(np.float32)), tw, th, jcfg.tile_size)
  mask_j = jfun.tile_mask(size, tw, th, jcfg.tile_size)

  def loss(p_, f_, probe):
    it = jfun.stream_rasterize_with_mapping(p_, f_, mj, size, jcfg,
                                            probe=probe, tiled=True)
    err = it[:, :3, :] - tgt_j
    return (jnp.sum(mask_j * (err * err))
            + jnp.sum(mask_j[:, 0, :] * it[:, 3, :])), it

  probe = jnp.zeros((n, jfun.probe_width(jcfg)), jnp.float32)
  (_, it_j), gj = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                     has_aux=True)(pj, fj, probe)

  pc.assert_mappings_equal(mj, mt)
  np.testing.assert_array_equal(np.asarray(tgt_j), tgt.numpy())
  c = it_t.shape[1]
  assert_columns_close(it_t.detach().permute(0, 2, 1).reshape(-1, c).numpy(),
                       np.asarray(it_j).transpose(0, 2, 1).reshape(-1, c),
                       "image")
  thin = packed[:, 4:6].min(1) < THIN
  for name, a, b in zip(("g_packed", "g_feats", "g_probe"), gt, gj):
    assert float(np.abs(np.asarray(b)).max()) > 0.0, name
    assert_columns_close(a.numpy(), b, name, thin)
  return (p, f, tgt, mask, mt, fwd_bwd, gt), gj


@pytest.mark.parametrize("case", ["uniform", "heavy", "depth12"])
def test_scene_step_matches_reference(scenes, case):
  data, shared = scenes
  packed, depth, feats, bits = data[case]
  (p, f, tgt, mask, mt, fwd_bwd, gt), gj = scene_step_vs_reference(
      packed, depth, feats, SIZE, bits,
      {k: shared[k] for k in tbench.MAP_KEYS}, shared["big_tile_window"])
  thin = packed[:, 4:6].min(1) < THIN
  if thin.any():
    # F16: on the thin splats both f32 sides stand within 1e-3 of the
    # column's largest from the port's own f64 twin
    m64 = dataclasses.replace(mt, table=mt.table.double())
    g64 = fwd_bwd(p.double(), f.double(), tgt.double(), mask.double(),
                  m64)[0].numpy()
    colmax = np.abs(g64).max(0)
    errs = [float((np.abs(np.asarray(g, np.float64) - g64)[thin]
                   / colmax).max()) for g in (gt[0].numpy(), gj[0])]
    assert max(errs) <= 1e-3, errs


@pytest.mark.slow
def test_scene_step_past_16383_tiles():
  """The compositing in the depth12 layout where the mapper takes it:
  2048x2048 at tile 16 (16,384 tiles), 300 splats of distinct 12-bit
  depth keys (``check_card.make_scene``: culled, below-threshold and wide
  splats, none thinner than 0.5 px), held as the cases above.  The
  reference's interpret-mode forward and backward walk 2,048 groups of 8
  tiles, which keeps this test out of tier 1 (PERF.md gives its time)."""
  size = (2048, 2048)
  packed, depth, feats = make_scene(300, size, n_culled=8, n_dim=8,
                                    n_wide=8)
  p, d, f = (torch.from_numpy(x) for x in (packed, depth, feats))
  cal = tbench.calibrate_stream(p, d, f, size, tbench._trainer_config(GW),
                                group_width=GW)
  scene_step_vs_reference(packed, depth, feats, size, 12,
                          {k: cal[k] for k in tbench.MAP_KEYS},
                          cal["big_tile_window"])
