"""Port vs reference: render_gaussians and the training step
render_with_heuristics end to end, plus the port's packaging contracts
(no JAX import, no build at import, entry points on the card)."""

import dataclasses
import os
import subprocess
import sys

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import port_compare as pc  # noqa: E402
from random_data import random_3d_gaussians, random_camera  # noqa: E402
import tpu_splatting as J  # noqa: E402
import tpu_splatting_torch as T  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# stream caps that fit this 500-splat scene (overflow asserted 0)
CONFIG = J.RasterConfig(tile_size=16, stream_num_slabs=2,
                        stream_strip_cap=512, stream_slab_cap=512,
                        stream_w_max=24, stream_run_cap=128,
                        stream_wide_cap=128, stream_dup_cap=1024)


def scene(seed=0, n=500, image_size=(64, 48)):
  rng = np.random.default_rng(seed)
  camera = random_camera(rng, image_size=image_size)
  g = random_3d_gaussians(rng, n, camera, scale_factor=1.0)
  sh = rng.standard_normal((n, 3, 16)).astype(np.float32) * 0.2
  return g.replace(feature=jnp.asarray(sh, jnp.float32)), camera


def test_render_gaussians_matches_reference():
  """SH degree 3, expected depth and the median-depth pass, atol 1e-5
  (plus rtol 1e-5: depth images are metric depths of up to ~50)."""
  g, camera = scene()
  rj = jax.jit(lambda g: J.render_gaussians(
      g, camera, CONFIG, use_sh=True, render_depth=True,
      render_median_depth=True))(g)
  assert int(rj.num_overflow) == 0
  with torch.no_grad():
    rt = T.render_gaussians(pc.gaussians(g), pc.camera(camera),
                            pc.config(CONFIG), use_sh=True,
                            render_depth=True, render_median_depth=True)
  assert int(rt.num_overflow) == 0
  np.testing.assert_array_equal(rt.overflow_by_cause.numpy(),
                                np.asarray(rj.overflow_by_cause))
  np.testing.assert_array_equal(rt.points.in_view.numpy(),
                                np.asarray(rj.points.in_view))
  assert float(rt.image_weight.max()) > 0.5
  for name in ("image", "image_weight", "depth_image",
               "median_depth_image"):
    got, want = getattr(rt, name), np.asarray(getattr(rj, name))
    assert tuple(got.shape) == want.shape, name
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5,
                               err_msg=name)


def test_render_tiled_layout():
  """tiled=True keeps tile layout; detile recovers the flat image."""
  from tpu_splatting_torch.mapper.tile_mapper import tile_shape
  from tpu_splatting_torch.rasterizer.stream_function import detile
  g, camera = scene(1, n=200)
  tg, tc, cfg = pc.gaussians(g), pc.camera(camera), pc.config(CONFIG)
  with torch.no_grad():
    flat = T.render_gaussians(tg, tc, cfg, use_sh=True)
    tiled = T.render_gaussians(tg, tc, cfg, use_sh=True, tiled=True)
  tw, th = tile_shape(camera.image_size, cfg.tile_size)
  assert tiled.tiled and tiled.image.shape == (tw * th, 3, 256)
  torch.testing.assert_close(
      detile(tiled.image, tw, th, cfg.tile_size, camera.image_size),
      flat.image, atol=0, rtol=0)


def test_outside_the_slice_raises():
  """Both pipelines stop at 65,535 tiles (16-bit tile ids): under
  pipeline="auto" a 4096x4096 image of 16-px tiles leaves the stream
  pipeline and the sorted mapper asserts, as in the reference.  Quantile
  mode is forward-only on both pipelines."""
  g, camera = scene(2, n=50)
  big = camera.replace(image_size=(4096, 4096))
  with pytest.raises(AssertionError, match="16-bit"):
    jax.jit(lambda g: J.render_gaussians(g, big, J.RasterConfig(),
                                         use_sh=True))(g)
  tg, tc = pc.gaussians(g), pc.camera(camera)
  with pytest.raises(AssertionError, match="16-bit"):
    T.render_gaussians(tg, pc.camera(big), T.RasterConfig(), use_sh=True)
  with pytest.raises(AssertionError, match="16-bit"):
    T.render_gaussians(tg, pc.camera(big),
                       T.RasterConfig(pipeline="sorted"), use_sh=True)

  from tpu_splatting_torch.rasterizer.function import rasterize
  from tpu_splatting_torch.rasterizer.stream_function import (
      stream_map_with_config, stream_rasterize_with_mapping)
  cfg = pc.config(CONFIG)
  g2d, depth, _ = T.perspective.project_to_image(tg, tc, cfg)
  feats = torch.rand(g2d.shape[0], 3, dtype=torch.float32)
  g2d = g2d.detach().requires_grad_(True)
  nd = torch.where(depth > 0, T.perspective.ndc_depth(depth, 0.1, 100.0), 0.0)
  m = stream_map_with_config(g2d.detach(), nd, feats, camera.image_size, cfg)
  quantile = dataclasses.replace(cfg, use_alpha_blending=False)
  q = stream_rasterize_with_mapping(g2d, feats, m, camera.image_size,
                                    quantile)
  assert not q[0].requires_grad
  q = rasterize(g2d, nd, feats, camera.image_size,
                dataclasses.replace(quantile, pipeline="sorted"))
  assert not q.image.requires_grad and not q.image_weight.requires_grad


# the sorted pipeline: chunks of 32 rows, capacity sized for these scenes
SORTED_CONFIG = dataclasses.replace(CONFIG, pipeline="sorted", chunk_size=32)
SORTED_CAP = 8192


def test_render_gaussians_sorted_matches_reference():
  """pipeline="sorted": SH degree 3, expected depth, the median-depth
  pass (the gather fallback: depth is another feature width than the
  mapping's) and forward visibility, atol / rtol 1e-5."""
  g, camera = scene(3)
  cfg = dataclasses.replace(SORTED_CONFIG, compute_visibility=True)
  rj = jax.jit(lambda g: J.render_gaussians(
      g, camera, cfg, use_sh=True, render_depth=True,
      render_median_depth=True, max_overlaps=SORTED_CAP))(g)
  assert int(rj.num_overflow) == 0
  with torch.no_grad():
    rt = T.render_gaussians(pc.gaussians(g), pc.camera(camera),
                            pc.config(cfg), use_sh=True, render_depth=True,
                            render_median_depth=True,
                            max_overlaps=SORTED_CAP)
  assert int(rt.num_overflow) == 0 and rt.overflow_by_cause is None
  assert float(rt.image_weight.max()) > 0.5
  for name in ("image", "image_weight", "depth_image",
               "median_depth_image"):
    got, want = getattr(rt, name), np.asarray(getattr(rj, name))
    assert tuple(got.shape) == want.shape, name
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5,
                               err_msg=name)
  np.testing.assert_allclose(rt.points.visibility.numpy(),
                             np.asarray(rj.points.visibility), atol=1e-5,
                             rtol=1e-4)
  with pytest.raises(AssertionError, match="stream-pipeline"):
    T.render_gaussians(pc.gaussians(g), pc.camera(camera), pc.config(cfg),
                       use_sh=True, tiled=True)


def flat_l2_loss(image_size):
  tgt = np.random.default_rng(7).random(
      (image_size[1], image_size[0], 3)).astype(np.float32)

  def loss_fn(rendering):
    err = rendering.image - (jnp.asarray(tgt, rendering.image.dtype)
                             if isinstance(rendering.image, jax.Array)
                             else torch.from_numpy(tgt).to(
                                 rendering.image.dtype))
    return (err * err).sum()
  return loss_fn


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_render_with_heuristics_sorted_matches_reference(dtype):
  """pipeline="sorted", SH degree 3, flat L2 loss: the loss, every
  Gaussians3D leaf's gradient, visibility (a forward product here),
  prune_cost and split_score; f64 to 1e-8, f32 as the stream test (F8)."""
  f64 = dtype == "float64"
  g, camera = scene(6, n=300)
  if f64:
    g = jax.tree.map(lambda x: x.astype(jnp.float64), g)
    camera = camera.replace(
        projection=camera.projection.astype(jnp.float64),
        T_camera_world=camera.T_camera_world.astype(jnp.float64))
  cfg = dataclasses.replace(SORTED_CONFIG, compute_point_heuristic=True,
                            compute_visibility=True)
  loss = flat_l2_loss(camera.image_size)
  lj, rj, gj = jax.jit(lambda g: J.render_with_heuristics(
      loss, g, camera, cfg, use_sh=True, max_overlaps=SORTED_CAP))(g)
  assert int(rj.num_overflow) == 0
  lt, rt, gt = T.render_with_heuristics(loss, pc.gaussians(g),
                                        pc.camera(camera), pc.config(cfg),
                                        use_sh=True, max_overlaps=SORTED_CAP)
  assert gt.position.dtype == getattr(torch, dtype)
  tight = dict(atol=1e-8, rtol=1e-8) if f64 else None
  np.testing.assert_allclose(float(lt), float(lj), rtol=1e-8 if f64 else 1e-5)
  for name in ("position", "log_scaling", "rotation", "alpha_logit",
               "feature"):
    want = np.asarray(getattr(gj, name))
    scale = float(np.abs(want).max())
    assert scale > 0.0, name
    np.testing.assert_allclose(getattr(gt, name).numpy(), want,
                               **(tight or dict(atol=1e-3 * scale, rtol=0)),
                               err_msg=name)
  for name in ("visibility", "prune_cost", "split_score"):
    want = np.asarray(getattr(rj.points, name))
    assert float(np.abs(want).max()) > 0.0, name
    np.testing.assert_allclose(getattr(rt.points, name).detach().numpy(),
                               want, **(tight or dict(atol=1e-4, rtol=1e-4)),
                               err_msg=name)


HEUR_CONFIG = dataclasses.replace(CONFIG, compute_point_heuristic=True,
                                  compute_visibility=True)


def tiled_l2_loss(xp, image_size, tile_size, entile, tile_mask):
  """The trainer's masked L2 loss in tile layout (bench.py:324-338), for
  either side: ``xp`` is jnp or torch."""
  tw, th = -(-image_size[0] // tile_size), -(-image_size[1] // tile_size)
  tgt_full = np.random.default_rng(7).random(
      (image_size[1], image_size[0], 3)).astype(np.float32)
  tgt = entile(xp.asarray(tgt_full), tw, th, tile_size)
  mask = tile_mask(image_size, tw, th, tile_size)

  def loss_fn(rendering):
    err = rendering.image - tgt
    return (mask * (err * err)).sum()
  return loss_fn


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_render_with_heuristics_matches_reference(dtype):
  """SH degree 3, tiled masked L2 loss: the loss, every Gaussians3D leaf's
  gradient, visibility, prune_cost and split_score.

  In f64 both sides agree to 1e-8 (they differ only in rounding).  In f32
  the loss holds to rtol 1e-5 and the per-point heuristics to atol / rtol
  1e-4, but the leaf gradients pass through the f32 projection, whose
  conditioning (ROADMAP F8) moves single entries by up to ~2e-4 of the
  leaf's largest gradient on either side: they are held to 1e-3 of it."""
  from tpu_splatting.rasterizer import stream_function as jfun
  from tpu_splatting_torch.rasterizer import stream_function as tfun
  f64 = dtype == "float64"
  g, camera = scene(4, n=300)
  if f64:
    g = jax.tree.map(lambda x: x.astype(jnp.float64), g)
    camera = camera.replace(
        projection=camera.projection.astype(jnp.float64),
        T_camera_world=camera.T_camera_world.astype(jnp.float64))
  size = camera.image_size
  loss_j = tiled_l2_loss(jnp, size, 16, jfun.entile, jfun.tile_mask)
  lj, rj, gj = jax.jit(lambda g: J.render_with_heuristics(
      loss_j, g, camera, HEUR_CONFIG, use_sh=True, tiled=True))(g)
  assert int(rj.num_overflow) == 0

  loss_t = tiled_l2_loss(torch, size, 16, tfun.entile, tfun.tile_mask)
  tg = pc.gaussians(g)
  lt, rt, gt = T.render_with_heuristics(loss_t, tg, pc.camera(camera),
                                        pc.config(HEUR_CONFIG), use_sh=True,
                                        tiled=True)
  assert gt.position.dtype == getattr(torch, dtype)
  assert tg.position.grad is None and not tg.position.requires_grad
  tight = dict(atol=1e-8, rtol=1e-8) if f64 else None
  np.testing.assert_allclose(float(lt), float(lj), rtol=1e-8 if f64 else 1e-5)
  for name in ("position", "log_scaling", "rotation", "alpha_logit",
               "feature"):
    want = np.asarray(getattr(gj, name))
    scale = float(np.abs(want).max())
    assert scale > 0.0, name
    np.testing.assert_allclose(getattr(gt, name).numpy(), want,
                               **(tight or dict(atol=1e-3 * scale, rtol=0)),
                               err_msg=name)
  for name in ("visibility", "prune_cost", "split_score"):
    want = np.asarray(getattr(rj.points, name))
    assert float(np.abs(want).max()) > 0.0, name
    np.testing.assert_allclose(getattr(rt.points, name).numpy(), want,
                               **(tight or dict(atol=1e-4, rtol=1e-4)),
                               err_msg=name)


def test_probe_less_visibility_matches_reference():
  """render_gaussians with compute_visibility and no probe runs one extra
  backward under a zero image cotangent (inside torch.no_grad too)."""
  g, camera = scene(5, n=300)
  cfg = dataclasses.replace(CONFIG, compute_visibility=True)
  rj = jax.jit(lambda g: J.render_gaussians(g, camera, cfg, use_sh=True))(g)
  with torch.no_grad():
    rt = T.render_gaussians(pc.gaussians(g), pc.camera(camera),
                            pc.config(cfg), use_sh=True)
  want = np.asarray(rj.points.visibility)
  assert float(want.max()) > 0.1
  np.testing.assert_allclose(rt.points.visibility.numpy(), want, atol=1e-5,
                             rtol=1e-4)


def test_viewspace_gradient():
  grad = np.random.default_rng(6).standard_normal((40, 7)).astype(np.float32)
  np.testing.assert_allclose(
      T.viewspace_gradient(torch.from_numpy(grad)).numpy(),
      np.asarray(J.viewspace_gradient(jnp.asarray(grad))), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["uniform_scene", "heavy_scene"])
def test_scene_generators_match_bench(name, seed):
  import bench
  from tpu_splatting_torch import scenes
  got = getattr(scenes, name)(np.random.default_rng(seed), 500, (64, 48))
  want = getattr(bench, name)(np.random.default_rng(seed), 500, (64, 48))
  for a, b in zip(got, want):
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def test_entry_points_default_to_the_card():
  """Without a device argument the port makes CUDA tensors, so here (no
  CUDA) the entry points raise instead of silently staying on the CPU."""
  from tpu_splatting_torch import convert, scenes
  if torch.cuda.is_available():
    pytest.skip("checks the behaviour where CUDA is absent")
  g, camera = scene(2, n=10)
  with pytest.raises((AssertionError, RuntimeError)):
    convert.gaussians3d_from_numpy(pc.fields(g))
  with pytest.raises((AssertionError, RuntimeError)):
    convert.camera_from_numpy(pc.fields(camera))
  packed, depth, feats = scenes.uniform_scene(np.random.default_rng(0), 10,
                                              (64, 48))
  with pytest.raises((AssertionError, RuntimeError)):
    scenes.lift_to_3d(packed, depth, feats, (64, 48), 0.1, 100.0, 70.0)


def test_import_needs_no_jax_and_builds_nothing():
  """Importing the port (and chip_smoke) leaves jax, triton,
  tpu_splatting and bench out of sys.modules and compiles no kernel
  (nvcc is absent here)."""
  code = (
      "import sys\n"
      "import tpu_splatting_torch, tpu_splatting_torch.convert, "
      "tpu_splatting_torch.scenes, tpu_splatting_torch.renderer, "
      "tpu_splatting_torch.optim, chip_smoke\n"
      "from tpu_splatting_torch.utils import cuda_build\n"
      "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
      "('jax', 'jaxlib', 'triton', 'tpu_splatting', 'bench'))\n"
      "assert not bad, bad\n"
      "assert not cuda_build._libs\n"
      "print('ok')\n")
  env = dict(os.environ)
  env.pop("PYTHONPATH", None)
  out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
  assert out.returncode == 0, out.stderr
  assert out.stdout.strip() == "ok"
