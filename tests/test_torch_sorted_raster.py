"""Port vs reference: the sorted-overlap rasterizer.

* K4's twin ``kernels.forward_reference`` against the JAX
  ``kernels.forward`` (interpret mode): image and per-overlap visibility
  to 1e-5 in f32 and 1e-10 in f64; blending, antialias and quantile
  modes, visibility on and off, on the JAX-built and the port-built
  mapping; and the port's rasterize against its own numpy oracle.
* K5's twin ``kernels.backward_reference`` against the JAX
  ``kernels.backward``: per column, max error <= 1e-5 of the column's
  largest value (f32), heuristics on and off, plain and antialias.
* ``rasterize``: per-point gradients and heuristics against ``jax.grad``
  in f64 to 1e-8, an f64 ``torch.autograd.gradcheck`` of the twin path on
  one 8x8 tile, visibility = feature gradient under an all-ones
  cotangent, and quantile mode forward-only.

The scenes are those of tests/test_rasterizer.py.  The kernels are held
against the twins on the card (test_torch_gpu.py, chip_smoke.py).
"""

import dataclasses
import functools

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import port_compare as pc  # noqa: E402
from random_data import random_2d_gaussians  # noqa: E402
from test_rasterizer import make_scene  # noqa: E402
from tpu_splatting import RasterConfig  # noqa: E402
from tpu_splatting.mapper import tile_mapper as jmap  # noqa: E402
from tpu_splatting.rasterizer import function as jfun  # noqa: E402
from tpu_splatting.rasterizer import kernels as jkern  # noqa: E402
from tpu_splatting_torch.mapper import tile_mapper as tmap  # noqa: E402
from tpu_splatting_torch.rasterizer import function as tfun  # noqa: E402
from tpu_splatting_torch.rasterizer import kernels as tkern  # noqa: E402
from tpu_splatting_torch.rasterizer.reference import (  # noqa: E402
    rasterize_reference)

SIZE = (32, 24)
MODES = {
    "blend": dict(),
    "antialias": dict(antialias=True),
    "quantile": dict(use_alpha_blending=False, saturate_threshold=0.25),
}


MAP_CONFIG = RasterConfig(tile_size=8, chunk_size=8)


def mapped(seed, dtype, n=50):
  """(packed, depth, feats) numpy, JAX mapping, port mapping (the mapping
  does not depend on the compositing mode: one compile per dtype)."""
  config = MAP_CONFIG
  g2, packed = make_scene(seed, n=n, image_size=SIZE, dtype=dtype)
  packed, depth, feats = (np.array(packed), np.array(g2.depths),
                          np.array(g2.feature))
  mj = jmap.map_to_tiles(jnp.asarray(packed), jnp.asarray(depth), SIZE,
                         config, max_overlaps=512,
                         features=jnp.asarray(feats))
  mt = tmap.map_to_tiles(pc.t(packed), pc.t(depth), SIZE, pc.config(config),
                         max_overlaps=512, features=pc.t(feats))
  assert int(mj.num_overflow) == 0
  return packed, depth, feats, mj, mt


@functools.lru_cache(maxsize=None)
def jax_forward(mode, dtype):
  """The reference's forward with visibility on the JAX mapping (one
  interpret-mode run per mode and dtype, shared by the cases)."""
  config = RasterConfig(tile_size=8, chunk_size=8, **MODES[mode])
  _, _, _, mj, mt = mapped(1, getattr(jnp, dtype))
  img, vis = jkern.forward(mj.sorted_payload, mj.chunk_src, mj.chunk_cnt,
                           mj.chunk_to_tile, config, mj.num_tiles,
                           mj.tiles_wide, with_vis=True)
  return config, mj, mt, np.asarray(img), np.asarray(vis)


@pytest.mark.parametrize("mode,dtype,source", [
    *((m, d, "jax_mapping") for m in sorted(MODES)
      for d in ("float32", "float64")),
    ("blend", "float32", "port_mapping"),
    ("quantile", "float32", "port_mapping")])
def test_forward_twin_matches_reference(mode, dtype, source):
  """On the port's mapping the twin runs without visibility."""
  config, mj, mt, img_j, vis_j = jax_forward(mode, dtype)
  with_vis = source == "jax_mapping"
  m = pc.tile_mapping(mj) if with_vis else mt
  img_t, vis_t = tkern.forward(m.sorted_payload, m.chunk_src, m.chunk_cnt,
                               m.chunk_to_tile, pc.config(config),
                               m.num_tiles, m.tiles_wide, with_vis=with_vis)
  tol = (dict(atol=1e-10, rtol=1e-10) if dtype == "float64"
         else dict(atol=1e-5, rtol=1e-5))
  assert img_t.shape == img_j.shape and img_t.dtype == getattr(torch, dtype)
  # row T is the dummy tile: undefined in the reference, zero here
  want = img_j[:-1]
  assert float(np.abs(want).max()) > 0.1
  np.testing.assert_allclose(img_t[:-1].numpy(), want, **tol)
  assert not bool(img_t[-1].any())
  if with_vis:
    np.testing.assert_allclose(vis_t.numpy(), vis_j, **tol)
  else:
    assert vis_t is None


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_rasterize_matches_oracle(seed, mode):
  """The port's rasterize_with_tiles (f64) against the port's own
  sequential oracle, as tests/test_rasterizer.py holds the reference."""
  config = RasterConfig(tile_size=8, chunk_size=8, compute_visibility=True,
                        **MODES[mode])
  scale, alphas, channels = ((2.0, (0.4, 0.95), 1) if mode == "quantile"
                             else (1.0, (0.1, 0.9), 3))
  g2, packed = make_scene(seed + 20, n=50, image_size=SIZE, dtype=jnp.float64,
                          scale_factor=scale, alpha_range=alphas,
                          num_channels=channels)
  packed, depth, feats = (pc.t(packed), pc.t(g2.depths), pc.t(g2.feature))
  config = pc.config(config)
  m = tmap.map_to_tiles(packed, depth, SIZE, config, max_overlaps=2048)
  assert int(m.num_overflow) == 0
  out = tfun.rasterize_with_tiles(packed, feats, m, SIZE, config)
  img, alpha, vis = rasterize_reference(packed, feats, m, SIZE, config)
  np.testing.assert_allclose(out.image.numpy(), img, atol=1e-10)
  np.testing.assert_allclose(out.image_weight.numpy(), alpha, atol=1e-10)
  np.testing.assert_allclose(out.visibility.numpy(), vis, atol=1e-10)


@functools.lru_cache(maxsize=None)
def jax_backward(antialias):
  """The reference's backward with heuristics (its first 7 + F columns are
  the rows without them), one interpret-mode run per mode."""
  config = RasterConfig(tile_size=8, chunk_size=8, antialias=antialias,
                        compute_point_heuristic=True)
  _, _, _, mj, _ = mapped(2, jnp.float32)
  args = (mj.chunk_src, mj.chunk_cnt, mj.chunk_to_tile)
  img_j, _ = jkern.forward(mj.sorted_payload, *args, config, mj.num_tiles,
                           mj.tiles_wide, with_vis=False)
  gimg = np.random.default_rng(3).standard_normal(img_j.shape).astype(
      np.float32)
  want = np.asarray(jkern.backward(mj.sorted_payload, img_j,
                                   jnp.asarray(gimg), *args, config,
                                   mj.num_tiles, mj.tiles_wide))
  return mj, np.array(img_j), gimg, want


@pytest.mark.parametrize("heur", [False, True])
@pytest.mark.parametrize("antialias", [False, True])
def test_backward_twin_matches_reference(antialias, heur):
  config = RasterConfig(tile_size=8, chunk_size=8, antialias=antialias,
                        compute_point_heuristic=heur)
  mj, img_j, gimg, want = jax_backward(antialias)
  want = want if heur else want[:, :10]
  m = pc.tile_mapping(mj)
  got = tkern.backward(m.sorted_payload, torch.from_numpy(img_j),
                       torch.from_numpy(gimg), m.chunk_src, m.chunk_cnt,
                       m.chunk_to_tile, pc.config(config), m.num_tiles,
                       m.tiles_wide).numpy()
  assert got.shape == want.shape == (m.num_chunks * 8, 10 + (2 if heur
                                                             else 0))
  scale = np.abs(want).max(0)
  assert (scale > 0).all()
  assert (np.abs(got - want).max(0) <= 1e-5 * scale).all(), (
      np.abs(got - want).max(0) / scale)


def loss_inputs(seed=3, n=30, size=(16, 16)):
  g2, packed = make_scene(seed, n=n, image_size=size, dtype=jnp.float64)
  packed = np.array(packed)
  packed[n // 2:, 0] += 40.0          # push some points out of the image
  target = np.random.default_rng(seed).random((size[1], size[0], 3))
  return packed, np.array(g2.depths), np.array(g2.feature), target, size


@pytest.mark.parametrize("antialias", [False, True])
def test_rasterize_gradients_match_jax(antialias):
  """f64: d loss / d (packed, features) and the heuristic probe's
  gradient (prune, split), and the forward visibility, to 1e-8."""
  config = RasterConfig(tile_size=8, chunk_size=8, antialias=antialias,
                        compute_point_heuristic=True,
                        compute_visibility=True, pipeline="sorted")
  packed, depth, feats, target, size = loss_inputs()
  n = packed.shape[0]

  def loss_j(p, f, probe):
    out = jfun.rasterize(p, jnp.asarray(depth), f, size, config,
                         max_overlaps=512, heuristic_probe=probe)
    return (jnp.sum((out.image - target) ** 2)
            + jnp.sum(out.image_weight ** 2)), out.visibility

  (gp_j, gf_j, gh_j), vis_j = jax.grad(loss_j, argnums=(0, 1, 2),
                                       has_aux=True)(
      jnp.asarray(packed), jnp.asarray(feats), jnp.zeros((n, 2)))

  p_t = pc.t(packed).requires_grad_(True)
  f_t = pc.t(feats).requires_grad_(True)
  probe = torch.zeros((n, 2), dtype=torch.float64, requires_grad=True)
  out = tfun.rasterize(p_t, pc.t(depth), f_t, size, pc.config(config),
                       max_overlaps=512, heuristic_probe=probe)
  loss = (((out.image - torch.from_numpy(target)) ** 2).sum()
          + (out.image_weight ** 2).sum())
  loss.backward()
  assert int(out.num_overflow) == 0
  for got, want in ((p_t.grad, gp_j), (f_t.grad, gf_j), (probe.grad, gh_j),
                    (out.visibility, vis_j)):
    want = np.asarray(want)
    assert float(np.abs(want).max()) > 0
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-8,
                               rtol=1e-8)
  # points pushed out of the image get nothing
  assert not bool(probe.grad[n // 2:].any())


@pytest.mark.parametrize("antialias", [False, True])
def test_rasterize_gradcheck(antialias):
  """f64 gradcheck of the twin path through the mapper, on one 8x8 tile
  (the reference's test_rasterizer_gradcheck scene, seed 0)."""
  config = RasterConfig(tile_size=8, chunk_size=8, antialias=antialias,
                        pipeline="sorted")
  size = (8, 8)
  g2 = random_2d_gaussians(np.random.default_rng(0), 14, size,
                           num_channels=2, scale_factor=0.8,
                           dtype=jnp.float64)
  mean = pc.t(g2.position)
  rot = pc.t(g2.rotation)
  axis = rot / torch.linalg.norm(rot, dim=1, keepdim=True)
  sigma = pc.t(g2.scaling)
  alpha = torch.sigmoid(pc.t(g2.alpha_logit)[:, 0])
  depth, feats = pc.t(g2.depths), pc.t(g2.feature)
  cfg = pc.config(config)

  def f(mean, axis, sigma, alpha, feats):
    packed = torch.cat([mean, axis, sigma, alpha[:, None]], -1)
    out = tfun.rasterize(packed, depth, feats, size, cfg, max_overlaps=64)
    return out.image, out.image_weight

  inputs = tuple(x.clone().requires_grad_(True)
                 for x in (mean, axis, sigma, alpha, feats))
  assert torch.autograd.gradcheck(f, inputs, eps=1e-7, atol=5e-7,
                                  rtol=5e-5, fast_mode=True)


def test_visibility_equals_feature_gradient():
  """Under an all-ones image cotangent the feature gradient of a
  1-channel render equals the forward visibility (f64)."""
  config = RasterConfig(tile_size=8, chunk_size=8, compute_visibility=True,
                        pipeline="sorted")
  size = (32, 32)
  g2, packed = make_scene(7, n=60, image_size=size, num_channels=1)
  packed, depth = pc.t(packed), pc.t(g2.depths)
  feats = pc.t(g2.feature).requires_grad_(True)
  out = tfun.rasterize(packed, depth, feats, size, pc.config(config),
                       max_overlaps=1024)
  out.image.sum().backward()
  assert float(out.visibility.max()) > 0.1
  np.testing.assert_allclose(feats.grad[:, 0].numpy(),
                             out.visibility.numpy(), atol=1e-10)


def test_quantile_is_forward_only():
  config = RasterConfig(tile_size=8, chunk_size=8, use_alpha_blending=False,
                        saturate_threshold=0.25, pipeline="sorted")
  g2, packed = make_scene(4, n=30, image_size=SIZE)
  packed = pc.t(packed).requires_grad_(True)
  out = tfun.rasterize(packed, pc.t(g2.depths), pc.t(g2.feature), SIZE,
                       pc.config(config), max_overlaps=1024)
  assert not out.image.requires_grad
  assert not out.image_weight.requires_grad
  assert float(out.image_weight.max()) == 1.0


def test_stream_branch_of_rasterize():
  """rasterize's other branch: the tile-stream pipeline (held against the
  reference in test_torch_stream_*.py), with the caller's (N, 2)
  heuristic probe receiving the (prune, split) columns of the full probe."""
  from tpu_splatting_torch.rasterizer import stream_function as sfun
  config = pc.config(RasterConfig(
      tile_size=8, compute_point_heuristic=True, stream_num_slabs=2,
      stream_strip_cap=512, stream_slab_cap=512, stream_w_max=24,
      stream_run_cap=128, stream_wide_cap=128, stream_dup_cap=1024))
  packed, depth, feats, target, size = loss_inputs(5)
  n = packed.shape[0]
  target = torch.from_numpy(target)
  p_t = pc.t(packed).requires_grad_(True)
  probe = torch.zeros((n, 2), dtype=torch.float64, requires_grad=True)
  out = tfun.rasterize(p_t, pc.t(depth), pc.t(feats), size, config,
                       heuristic_probe=probe)
  assert out.visibility is None and int(out.num_overflow) == 0
  ((out.image - target) ** 2).sum().backward()

  p_s = pc.t(packed).requires_grad_(True)
  full = torch.zeros((n, 3), dtype=torch.float64, requires_grad=True)
  m = sfun.stream_map_with_config(p_s.detach(), pc.t(depth), pc.t(feats),
                                  size, config)
  img, _ = sfun.stream_rasterize_with_mapping(p_s, pc.t(feats), m, size,
                                              config, probe=full)
  ((img - target) ** 2).sum().backward()
  assert float(probe.grad.abs().max()) > 0
  np.testing.assert_array_equal(out.image.detach().numpy(),
                                img.detach().numpy())
  np.testing.assert_array_equal(p_t.grad.numpy(), p_s.grad.numpy())
  np.testing.assert_array_equal(probe.grad.numpy(), full.grad[:, 1:].numpy())


def test_gather_fallback_matches_payload_path():
  """A mapping built without features (and the median pass, whose width
  differs) reads gathered rows through identity windows; same result."""
  config = RasterConfig(tile_size=8, chunk_size=8, compute_visibility=True)
  packed, depth, feats, _, mt = mapped(6, jnp.float64)
  config = pc.config(config)
  bare = dataclasses.replace(mt, sorted_payload=None, feature_size=None)
  a = tfun.rasterize_with_tiles(pc.t(packed), pc.t(feats), mt, SIZE, config)
  b = tfun.rasterize_with_tiles(pc.t(packed), pc.t(feats), bare, SIZE,
                                config)
  for x, y in zip(a[:2] + a[3:4], b[:2] + b[3:4]):
    np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-12)
