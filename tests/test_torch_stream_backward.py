"""Port vs reference: the stream backward (K2 with K3 fused) and the
gradient reduce.

* The twin ``stream_backward_reference`` against the JAX
  ``merge_grad_slabs(stream_backward(...))`` in interpret mode, at that
  boundary (home-major columns), on the JAX-built mapping: quadratic,
  antialias, heuristics + visibility, and the wide-splat scene with
  duplicate rows.  atol 1e-5, rtol 1e-4 (f32, another summation order).
* Per-point gradients (g_gaussians2d, g_features, g_probe) through
  ``stream_rasterize_with_mapping`` against ``jax.grad`` through the JAX
  one, on the JAX-built and on the port-built mapping; atol / rtol 1e-4
  as tests/test_stream.py holds the stream gradients.
* ``reduce_stage2`` against both JAX branches (sort path, gather path).
* An f64 gradcheck of the twin path.

The scenes keep a_raw away from alpha_threshold (ROADMAP F1).  The
kernel itself is held against the twin in test_torch_gpu.py.
"""

import dataclasses
import functools

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import port_compare as pc  # noqa: E402
from test_stream import TIGHT, make_scene  # noqa: E402
from test_torch_stream_map import wide_scene  # noqa: E402
from tpu_splatting import RasterConfig  # noqa: E402
from tpu_splatting.parallel import stream_sharded as jss  # noqa: E402
from tpu_splatting.rasterizer import stream as jstream  # noqa: E402
from tpu_splatting.rasterizer import stream_function as jfun  # noqa: E402
from tpu_splatting.rasterizer import stream_kernels as jkern  # noqa: E402
from tpu_splatting_torch.benchmarks.thin_splats import thin_scene  # noqa: E402
from tpu_splatting_torch.parallel import stream_sharded as tss  # noqa: E402
from tpu_splatting_torch.rasterizer import stream as tstream  # noqa: E402
from tpu_splatting_torch.rasterizer import (  # noqa: E402
    stream_function as tfun)
from tpu_splatting_torch.rasterizer import (  # noqa: E402
    stream_kernels as tkern)

HEUR = dict(compute_point_heuristic=True, compute_visibility=True)
MODES = {
    "quadratic": dict(),
    "antialias": dict(antialias=True),
    "heuristics": HEUR,
    "antialias_heuristics": dict(antialias=True, **HEUR),
}


def scene(case):
  """(packed, depths, feats, image size, extra stream_map caps)."""
  if case == "wide":
    packed, depths, feats, size = wide_scene()
    return packed, depths, feats, size, dict(wide_cap=64, dup_cap=512)
  packed, depths, feats = make_scene(0, 80, (32, 24))
  return (np.asarray(packed), np.asarray(depths), np.asarray(feats),
          (32, 24), {})


def jax_mapping(packed, depths, feats, size, caps, config):
  mj = jstream.stream_map(jnp.asarray(packed, jnp.float32),
                          jnp.asarray(depths, jnp.float32),
                          jnp.asarray(feats, jnp.float32), size, config,
                          group_width=2, **{**TIGHT, **caps})
  assert int(mj.num_overflow) == 0
  return mj


def port_mapping(packed, depths, feats, size, caps, config):
  mt = tstream.stream_map(pc.t(packed, torch.float32),
                          pc.t(depths, torch.float32),
                          pc.t(feats, torch.float32), size, pc.config(config),
                          group_width=2, **{**TIGHT, **caps})
  assert int(mt.num_overflow) == 0
  return mt


@pytest.mark.parametrize("case,mode", [
    ("tight", "quadratic"), ("tight", "antialias"),
    ("tight", "heuristics"), ("wide", "heuristics")])
def test_twin_matches_merged_slabs(case, mode):
  packed, depths, feats, size, caps = scene(case)
  config = RasterConfig(tile_size=8, chunk_size=8, big_tile_window=16,
                        **MODES[mode])
  mj = jax_mapping(packed, depths, feats, size, caps, config)
  img = jkern.stream_forward(mj, config)
  gimg = jnp.asarray(np.random.default_rng(1).standard_normal(
      img.shape).astype(np.float32))
  slabw = jkern.slab_width(config, feats.shape[1])
  cols = jkern.merge_grad_slabs(
      jkern.stream_backward(mj, img, gimg, config, mj.run_cap), mj,
      mj.run_cap, slabw)
  want = np.stack([np.asarray(c) for c in cols], -1)
  got = tkern.stream_backward(pc.mapping(mj), pc.t(img), pc.t(gimg),
                              pc.config(config)).numpy()
  r_rows = mj.num_tiles * mj.run_cap
  assert got.shape == (r_rows + 1, slabw)
  assert not got[r_rows].any()                 # the sentinel row
  assert float(np.abs(want).max()) > 0.1
  np.testing.assert_allclose(got[:r_rows], want, atol=1e-5, rtol=1e-4)


def assert_columns_within(got, want, label):
  """Each column within 1e-4 * its largest |want| + 1e-6."""
  err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
  tol = 1e-4 * np.abs(np.asarray(want, np.float64)).max(0) + 1e-6
  assert (err <= tol).all(), (label, (err / tol).max(0).tolist())


@pytest.mark.parametrize("mode,band0", [("quadratic", 0), ("heuristics", 2)])
def test_thin_splats_match_reference_and_f64(mode, band0):
  """F16: on splats 0.03-0.1 px thin, the f32 twin against the JAX
  ``merge_grad_slabs(stream_backward(...))`` and against the port's own
  f64 twin on the same image and cotangent, each column within 1e-4 of
  its largest + 1e-6 (the per-pixel form erred by up to 5.1e-4 here).
  ``band0`` 2 runs the lower half of the image as the second of two band
  shards (halo mode, neither neighbour's band added: both sides lose the
  same rows).  The scene is ``benchmarks.thin_splats.thin_scene`` (36 of
  48 splats 0.03-0.1 px thin).  The image is the port's f32 forward: the
  forward's own f32 error on thin splats (ROADMAP F20) is not the
  backward's."""
  packed, depths, feats, size = thin_scene()
  config = RasterConfig(tile_size=8, chunk_size=8, big_tile_window=16,
                        **MODES[mode])
  mj = jax_mapping(packed, depths, feats, size, dict(run_cap=32), config)
  mt = pc.mapping(mj)
  cfg = pc.config(config)
  slabw = jkern.slab_width(config, feats.shape[1])
  rc = mj.run_cap
  if band0:
    th_local = mj.tiles_high - band0
    gpb = mj.tiles_wide // mj.group_width * th_local
    sl = slice(gpb, 2 * gpb)
    mj = jss._local_mapping(mj, mj.desc[sl], mj.strip_blk[sl], mj.table,
                            mj.run_starts, (mj.num_overflow, mj.overflow),
                            th_local)
    mt = tss._local_mapping(mt, 1, th_local, "cpu")
  img = tkern.stream_forward(mt, cfg, band0)
  gimg = torch.from_numpy(np.random.default_rng(2).standard_normal(
      tuple(img.shape)).astype(np.float32))
  gout = jkern.stream_backward(mj, jnp.asarray(img.numpy()),
                               jnp.asarray(gimg.numpy()), config, rc,
                               band0=band0)
  if band0:
    zero = jnp.zeros_like(gout[:mj.tiles_wide // mj.group_width])
    gout = jnp.concatenate([zero, gout, zero], 0)
  cols = jkern.merge_grad_slabs(gout, mj, rc, slabw, halo=bool(band0))
  want = np.stack([np.asarray(c) for c in cols], -1)
  own = slice(mt.tiles_wide * rc if band0 else 0, None)

  def twin(m, image, g):
    buf = tkern.stream_backward(m, image, g, cfg, band0, halo=bool(band0))
    return buf[own][:want.shape[0]].numpy()

  got = twin(mt, img, gimg)
  g64 = twin(dataclasses.replace(mt, table=mt.table.double()), img.double(),
             gimg.double())
  assert float(np.abs(want[:, :7]).max()) > 0.1
  assert_columns_within(got, want, "f32 twin vs the reference")
  assert_columns_within(got, g64, "f32 twin vs the f64 twin")


def test_window_grad_rows_match_run_starts():
  """Each window row's buffer row, derived from the descriptor's gbuf_dst
  and class, equals the one a binary search over run_starts gives: table
  row j of home h lands at h * run_cap + j - run_starts[h]."""
  packed, depths, feats, size, caps = scene("wide")
  config = RasterConfig(tile_size=8, chunk_size=8, big_tile_window=16)
  m = port_mapping(packed, depths, feats, size, caps, config)
  _, lnc, row0 = tkern._window_slots(m)
  grow0 = tkern.window_grad_rows(m)
  starts = m.run_starts.long()
  checked = 0
  for ln, r0, g0 in zip(lnc.flatten().tolist(), row0.flatten().tolist(),
                        grow0.flatten().tolist()):
    if ln > 0:
      j = torch.arange(r0, r0 + ln)
      home = torch.searchsorted(starts, j, right=True) - 1
      assert torch.equal(home * m.run_cap + j - starts[home],
                         torch.arange(g0, g0 + ln))
      checked += ln
  assert checked > 100


@functools.lru_cache(maxsize=None)
def jax_point_grads(mode):
  """(scene, JAX mapping, target, jax.grad of the loss w.r.t. gaussians2d,
  features and probe) — shared by both mapping sources."""
  packed, depths, feats, size, caps = scene("tight")
  config = RasterConfig(tile_size=8, chunk_size=8, **MODES[mode])
  mj = jax_mapping(packed, depths, feats, size, caps, config)
  tgt = np.random.default_rng(0).random((size[1], size[0], 3)).astype(
      np.float32)

  def loss_j(p, f, pr):
    img, w = jfun.stream_rasterize_with_mapping(p, f, mj, size, config,
                                                probe=pr)
    return jnp.sum((img - tgt) ** 2) + jnp.sum(w ** 2)

  pw = jfun.probe_width(config)
  want = jax.grad(loss_j, argnums=(0, 1, 2))(
      jnp.asarray(packed), jnp.asarray(feats),
      jnp.zeros((packed.shape[0], pw)))
  return config, mj, tgt, [np.asarray(x) for x in want]


@pytest.mark.parametrize("source", ["jax_mapping", "port_mapping"])
@pytest.mark.parametrize("mode", ["heuristics", "antialias_heuristics"])
def test_point_gradients_match_jax(source, mode):
  packed, depths, feats, size, caps = scene("tight")
  config, mj, tgt, want = jax_point_grads(mode)
  n, pw = packed.shape[0], want[2].shape[1]
  mt = (pc.mapping(mj) if source == "jax_mapping"
        else port_mapping(packed, depths, feats, size, caps, config))
  args = [pc.t(packed).requires_grad_(True), pc.t(feats).requires_grad_(True),
          torch.zeros((n, pw), requires_grad=True)]
  img, w = tfun.stream_rasterize_with_mapping(
      args[0], args[1], mt, size, pc.config(config), probe=args[2])
  loss = ((img - torch.from_numpy(tgt)) ** 2).sum() + (w ** 2).sum()
  got = torch.autograd.grad(loss, args)
  assert float(np.abs(want[2]).max()) > 0.1
  for name, a, b in zip(("gaussians2d", "features", "probe"), got, want):
    np.testing.assert_allclose(a.numpy(), b, atol=1e-4, rtol=1e-4,
                               err_msg=name)


@pytest.mark.parametrize("branch", ["sort", "gather"])
def test_reduce_stage2_matches_both_branches(branch):
  """The port's gather-path stage 2 against the reference's sort path (a
  compact-R scene) and its gather path (the wide scene, long runs)."""
  if branch == "sort":
    packed, depths, feats, size, caps = scene("tight")
  else:
    packed, depths, feats, size, caps = scene("wide")
  config = RasterConfig(tile_size=8, chunk_size=8, big_tile_window=16)
  kw = dict(TIGHT, **caps)
  if branch == "gather":
    kw["run_cap"] = 4096
  mj = jstream.stream_map(jnp.asarray(packed, jnp.float32),
                          jnp.asarray(depths, jnp.float32),
                          jnp.asarray(feats, jnp.float32), size, config,
                          group_width=2, **kw)
  assert int(mj.num_overflow) == 0
  n, r_rows = mj.num_points, mj.num_tiles * mj.run_cap
  n_rows = n + mj.dup_cap
  sort_cost = (r_rows + n_rows) * 2.6
  gather_cost = r_rows * 0.1 + n_rows * 9.0 + mj.dup_cap * 14.0
  assert (sort_cost <= gather_cost) == (branch == "sort")
  slabw = 5
  buf = np.random.default_rng(2).standard_normal(
      (r_rows, slabw)).astype(np.float32)
  want = np.stack([np.asarray(c) for c in jfun.reduce_stage2(
      [jnp.asarray(buf[:, c]) for c in range(slabw)], mj, mj.run_cap)], -1)
  got = tfun.reduce_stage2(
      torch.from_numpy(np.concatenate([buf, np.zeros((1, slabw),
                                                     np.float32)])),
      pc.mapping(mj))
  np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def test_twin_gradcheck_f64():
  """f64 gradcheck of the twin path: the mapping's table is a copy of the
  inputs, so each evaluation rebuilds it from the perturbed inputs."""
  packed, depths, feats = make_scene(17, 30, (16, 16))
  config = pc.config(RasterConfig(tile_size=8, chunk_size=8, **HEUR))
  p0 = pc.t(packed, torch.float64).requires_grad_(True)
  f0 = pc.t(feats, torch.float64).requires_grad_(True)
  d = pc.t(depths, torch.float64)

  def f(p, f_):
    m = tstream.stream_map(p.detach(), d, f_.detach(), (16, 16), config,
                           group_width=2, **TIGHT)
    assert int(m.num_overflow) == 0
    img, w = tfun.stream_rasterize_with_mapping(p, f_, m, (16, 16), config)
    return img, w

  assert torch.autograd.gradcheck(f, (p0, f0), eps=1e-6, atol=1e-5,
                                  rtol=1e-5, fast_mode=True)


def test_cpu_tensors_take_the_twin():
  """A CPU mapping goes to the twin and launches no kernel; quantile mode
  has no backward."""
  packed, depths, feats, size, caps = scene("tight")
  config = RasterConfig(tile_size=8, chunk_size=8, **HEUR)
  tcfg = pc.config(config)
  m = port_mapping(packed, depths, feats, size, caps, config)
  img = tkern.stream_forward(m, tcfg)
  gimg = torch.ones_like(img)
  tkern.reset_launch_counts()
  out = tkern.stream_backward(m, img, gimg, tcfg)
  assert tkern.launch_counts["stream_backward"] == 0
  torch.testing.assert_close(
      out, tkern.stream_backward_reference(m, img, gimg, tcfg), atol=0,
      rtol=0)
  with pytest.raises(ValueError, match="quantile"):
    tkern.stream_backward(m, img, gimg, dataclasses.replace(
        tcfg, use_alpha_blending=False))
