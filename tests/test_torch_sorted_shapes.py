"""Port vs reference: the sorted-overlap pipeline past the headline's
shapes.

64 feature channels (wider than any register instantiation of the port's
kernels: they take the generic one) and ``tile_size`` 4 (16 pixels, half
a warp: the kernels pad the block with frozen lanes).  On the CPU the
port runs its plain twins, so this holds the twins and the mapper at
those shapes against the JAX package in interpret mode: ``rasterize``'s
image, weight and visibility, and the gradients of a loss with respect to
the packed splats, the features and the heuristic probe (prune, split),
in f64 to 1e-8 (as tests/test_torch_sorted_raster.py holds ``rasterize``).
The kernels themselves are held against the twins at these shapes on the
card (test_torch_gpu.py, chip_smoke.py).
"""

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import port_compare as pc  # noqa: E402
from test_rasterizer import make_scene  # noqa: E402
from tpu_splatting import RasterConfig  # noqa: E402
from tpu_splatting.rasterizer import function as jfun  # noqa: E402
from tpu_splatting_torch.rasterizer import function as tfun  # noqa: E402

SIZE = (16, 16)
MAX_OVERLAPS = 1024


@pytest.mark.parametrize("num_features,tile_size", [(64, 8), (3, 4)])
def test_rasterize_and_gradients_match_jax(num_features, tile_size):
  config = RasterConfig(tile_size=tile_size, chunk_size=8,
                        compute_point_heuristic=True,
                        compute_visibility=True, pipeline="sorted")
  n = 30
  g2, packed = make_scene(3, n=n, image_size=SIZE, dtype=jnp.float64)
  packed = np.array(packed)
  packed[n // 2:, 0] += 40.0          # push some points out of the image
  depth = np.array(g2.depths)
  rng = np.random.default_rng(3)
  feats = rng.uniform(0.0, 1.0, (n, num_features))
  target = rng.random((SIZE[1], SIZE[0], num_features))

  def loss_j(p, f, probe):
    out = jfun.rasterize(p, jnp.asarray(depth), f, SIZE, config,
                         max_overlaps=MAX_OVERLAPS, heuristic_probe=probe)
    loss = (jnp.sum((out.image - target) ** 2)
            + jnp.sum(out.image_weight ** 2))
    return loss, (out.image, out.image_weight, out.visibility)

  (_, fwd_j), grads_j = jax.value_and_grad(
      loss_j, argnums=(0, 1, 2), has_aux=True)(
          jnp.asarray(packed), jnp.asarray(feats), jnp.zeros((n, 2)))

  p_t = pc.t(packed).requires_grad_(True)
  f_t = pc.t(feats).requires_grad_(True)
  probe = torch.zeros((n, 2), dtype=torch.float64, requires_grad=True)
  out = tfun.rasterize(p_t, pc.t(depth), f_t, SIZE, pc.config(config),
                       max_overlaps=MAX_OVERLAPS, heuristic_probe=probe)
  assert int(out.num_overflow) == 0
  assert out.image.shape == (SIZE[1], SIZE[0], num_features)
  loss = (((out.image - torch.from_numpy(target)) ** 2).sum()
          + (out.image_weight ** 2).sum())
  loss.backward()
  for got, want in zip((out.image, out.image_weight, out.visibility,
                        p_t.grad, f_t.grad, probe.grad),
                       (*fwd_j, *grads_j)):
    want = np.asarray(want)
    assert float(np.abs(want).max()) > 0
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-8,
                               rtol=1e-8)
  assert not bool(probe.grad[n // 2:].any())
