"""Port vs reference: render_gaussians end to end, plus the port's
packaging contracts (no JAX import, no build at import, loud backward)."""

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
  g, camera = scene(2, n=50)
  tg, tc = pc.gaussians(g), pc.camera(camera)
  for cfg, match in ((T.RasterConfig(pipeline="sorted"), "P9"),
                     (T.RasterConfig(compute_visibility=True), "P6")):
    with pytest.raises(NotImplementedError, match=match):
      T.render_gaussians(tg, tc, cfg, use_sh=True)
  with pytest.raises(NotImplementedError, match="P6"):
    T.render_with_heuristics(lambda r: r.image.sum(), tg, tc)


def test_backward_raises_until_ported():
  """Differentiating through the stream rasterizer fails loudly."""
  from tpu_splatting_torch.rasterizer.stream_function import (
      stream_map_with_config, stream_rasterize_with_mapping)
  g, camera = scene(3, n=100)
  tg, tc, cfg = pc.gaussians(g), pc.camera(camera), pc.config(CONFIG)
  g2d, depth, _ = T.perspective.project_to_image(tg, tc, cfg)
  feats = torch.rand(g2d.shape[0], 3, dtype=torch.float32)
  g2d = g2d.detach().requires_grad_(True)
  nd = torch.where(depth > 0, T.perspective.ndc_depth(depth, 0.1, 100.0), 0.0)
  m = stream_map_with_config(g2d.detach(), nd, feats, camera.image_size, cfg)
  img, w = stream_rasterize_with_mapping(g2d, feats, m, camera.image_size,
                                         cfg)
  assert img.requires_grad
  with pytest.raises(NotImplementedError, match="ROADMAP P6"):
    (img.sum() + w.sum()).backward()
  # quantile mode is forward-only: no graph at all
  q = stream_rasterize_with_mapping(
      g2d, feats, m, camera.image_size,
      dataclasses.replace(cfg, use_alpha_blending=False))
  assert not q[0].requires_grad


def test_import_needs_no_jax_and_builds_nothing():
  """Importing the port leaves jax, triton and tpu_splatting out of
  sys.modules and compiles no kernel (nvcc is absent here)."""
  code = (
      "import sys\n"
      "import tpu_splatting_torch, tpu_splatting_torch.convert, "
      "tpu_splatting_torch.scenes, tpu_splatting_torch.renderer\n"
      "from tpu_splatting_torch.utils import cuda_build\n"
      "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
      "('jax', 'jaxlib', 'triton', 'tpu_splatting'))\n"
      "assert not bad, bad\n"
      "assert not cuda_build._libs\n"
      "print('ok')\n")
  env = dict(os.environ)
  env.pop("PYTHONPATH", None)
  out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
  assert out.returncode == 0, out.stderr
  assert out.stdout.strip() == "ok"
