"""Port vs reference: the port's bench beyond the 2D protocol.

* ``make_full_step`` (the full renderer's timed step, through
  ``prepare_full``: the bench's uniform scene lifted to 3D with SH degree
  3, calibrated on its projected splats) against the JAX package's
  ``render_with_heuristics(..., use_sh=True, tiled=True)`` of the same
  masked L2 loss on the same inputs, 300 splats at 64x48: the loss and
  every ``Gaussians3D`` leaf's gradient, in f32 to 1e-3 of each leaf's
  largest gradient (the f32 projection's conditioning, ROADMAP F8) and in
  f64 to 1e-8.
* The depth12 key layout where the mapper takes it: a 2048x2048 image at
  tile 16 (16,384 tiles, past 16,383) with 300 splats of distinct 12-bit
  depth keys, mapped by both ``stream_map``s with the port's calibrated
  capacities: ``depth_bits`` 12 on both sides and every integer field
  equal.  The forward and backward on that scene against the reference
  take about 650 s on the CPU (the reference's interpret mode walks 2,048
  groups of 8 tiles), so they are the ``slow`` test of
  tests/test_torch_bench.py; tier 1 holds them at a small image with
  ``depth_bits=12``, and ``chip_smoke.py`` phase 13 at 49,152 tiles on
  the card against the twins.
"""

import dataclasses

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import port_compare as pc  # noqa: E402
import tpu_splatting as J  # noqa: E402
from tpu_splatting.rasterizer import stream as jstream  # noqa: E402
from tpu_splatting.rasterizer import stream_function as jfun  # noqa: E402
from tpu_splatting_torch import bench as tbench  # noqa: E402
from tpu_splatting_torch.benchmarks.check_card import make_scene  # noqa: E402


@pytest.fixture(autouse=True)
def cache_in_tmp(tmp_path, monkeypatch):
  """Every test's calibration cache lies in its temporary directory."""
  monkeypatch.setattr(tbench, "CAL_PATH", str(tmp_path / "bench_cal.json"))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_full_step_matches_reference(dtype):
  size, gw = (64, 48), 4
  f64 = dtype == "float64"
  step, g3d, cam, cfg = tbench.prepare_full(
      "uniform", *tbench.scene_arrays("uniform", 300, size), gw, size, "cpu")
  tgt, mask = tbench.loss_target(size, cfg.tile_size, "cpu")
  if f64:
    g3d = g3d.replace(**{f.name: getattr(g3d, f.name).double()
                         for f in dataclasses.fields(g3d)})
    cam = cam.replace(projection=cam.projection.double(),
                      T_camera_world=cam.T_camera_world.double())
    step = tbench.make_full_step(cam, cfg, tgt.double(), mask.double())
  lt, gt, overflow, by_cause = step(g3d)
  assert int(overflow) == 0 and by_cause.tolist() == [0] * 5
  assert gt.position.dtype == getattr(torch, dtype)

  xdt = jnp.float64 if f64 else jnp.float32
  gj = J.Gaussians3D(**{f.name: jnp.asarray(getattr(g3d, f.name).numpy(), xdt)
                        for f in dataclasses.fields(g3d)})
  camj = J.CameraParams(
      projection=jnp.asarray(cam.projection.numpy(), xdt),
      T_camera_world=jnp.asarray(cam.T_camera_world.numpy(), xdt),
      near_plane=cam.near_plane, far_plane=cam.far_plane, image_size=size)
  jcfg = J.RasterConfig(**dataclasses.asdict(cfg))
  ts = cfg.tile_size
  tw, th = size[0] // ts, size[1] // ts
  tgt_j = jfun.entile(jnp.asarray(np.random.default_rng(7).random(
      (size[1], size[0], 3)).astype(np.float32)), tw, th, ts)
  mask_j = jfun.tile_mask(size, tw, th, ts)
  np.testing.assert_array_equal(np.asarray(tgt_j), tgt.numpy())

  def loss_j(rendering):
    err = rendering.image - tgt_j
    return jnp.sum(mask_j * (err * err))

  lj, rj, grads_j = jax.jit(lambda g: J.render_with_heuristics(
      loss_j, g, camj, jcfg, use_sh=True, tiled=True))(gj)
  assert int(rj.num_overflow) == 0
  np.testing.assert_allclose(float(lt), float(lj), rtol=1e-8 if f64 else 1e-5)
  for f in dataclasses.fields(gt):
    want = np.asarray(getattr(grads_j, f.name))
    scale = float(np.abs(want).max())
    assert scale > 0.0, f.name
    tol = dict(atol=1e-8, rtol=1e-8) if f64 else dict(atol=1e-3 * scale,
                                                       rtol=0)
    np.testing.assert_allclose(getattr(gt, f.name).numpy(), want, **tol,
                               err_msg=f.name)


def test_depth12_mapping_past_16383_tiles():
  size, n, gw = (2048, 2048), 300, 8
  packed, depth, feats = make_scene(n, size, n_culled=8, n_dim=8, n_wide=8)
  assert len(np.unique((depth[depth > 0] * 65535).astype(np.int64) >> 4)) \
      == int((depth > 0).sum())
  p, d, f = (torch.from_numpy(x) for x in (packed, depth, feats))
  cal = tbench.calibrate_scene("depth12", p, d, f, size, gw)
  cfg = dataclasses.replace(tbench._trainer_config(gw),
                            big_tile_window=cal["big_tile_window"])
  caps = {**{k: cal[k] for k in tbench.MAP_KEYS}, "group_width": gw}
  map_f, _ = tbench.make_scene_step(size, cfg, caps)
  mt = map_f(p, d, f)
  assert (mt.num_tiles, mt.depth_bits, int(mt.num_overflow)) == (16384, 12, 0)
  jcfg = J.RasterConfig(**dataclasses.asdict(cfg))
  mj = jstream.stream_map(jnp.asarray(packed), jnp.asarray(depth),
                          jnp.asarray(feats), size, jcfg, **caps)
  assert mj.depth_bits == 12
  pc.assert_mappings_equal(mj, mt)


@pytest.mark.slow
def test_heavy_calibration_at_2m_matches_reference():
  """The bench's heavy scene at its full size (2M splats, 2048x1536,
  group width 8): the port's ``calibrate_stream`` equals the JAX
  package's in every field, and both differ from the repository's
  ``.bench_cal.json`` entry ``heavy_gw8_v7`` in w_max (58 against 57),
  max_tile_rows (1114 against 3623) and max_slab_rows (624 against 628):
  that entry predates the reference's current calibration (ROADMAP F17).
  About 20 minutes on the CPU, most of it the reference's (at the XLA
  optimization level tests/conftest.py sets)."""
  import json
  import os
  from tpu_splatting.rasterizer.stream import calibrate_stream
  arrays = tbench.scene_arrays("heavy")
  cfg = tbench._trainer_config(8)
  want = calibrate_stream(*(jnp.asarray(x) for x in arrays),
                          tbench.IMAGE_SIZE, J.RasterConfig(
                              **dataclasses.asdict(cfg)), group_width=8)
  got = tbench.calibrate_stream(*(torch.from_numpy(x) for x in arrays),
                                tbench.IMAGE_SIZE, cfg, group_width=8)
  want = {k: (v if isinstance(v, list) else int(v)) for k, v in want.items()}
  assert got == want
  root = os.path.join(os.path.dirname(os.path.dirname(
      os.path.abspath(__file__))), ".bench_cal.json")
  with open(root) as fh:
    cached = json.load(fh)["heavy_gw8_v7"]
  assert sorted(k for k in cached if cached[k] != got[k]) == [
      "max_slab_rows", "max_tile_rows", "w_max"]
