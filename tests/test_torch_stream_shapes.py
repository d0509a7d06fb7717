"""Port vs reference: the stream pipeline past the headline's shapes.

64 feature channels (wider than any register instantiation of the port's
kernels: they take the generic one) and ``tile_size`` 4 (16 pixels, half
a warp: the kernels pad the block with frozen lanes).  On the CPU the
port runs its plain twins, so this holds the twins and the mapper at
those shapes against the JAX package in interpret mode: the image and
weight of ``stream_rasterize_with_mapping`` (atol / rtol 1e-5) and the
per-point gradients through it, heuristics probe included (atol / rtol
1e-4, as tests/test_stream.py holds the stream gradients), on the JAX-built
and on the port-built mapping.  The kernels themselves are held against
the twins at these shapes on the card (test_torch_gpu.py, chip_smoke.py).
"""

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import port_compare as pc  # noqa: E402
from test_stream import TIGHT, make_scene  # noqa: E402
from tpu_splatting import RasterConfig  # noqa: E402
from tpu_splatting.rasterizer import stream as jstream  # noqa: E402
from tpu_splatting.rasterizer import stream_function as jfun  # noqa: E402
from tpu_splatting_torch.rasterizer import stream as tstream  # noqa: E402
from tpu_splatting_torch.rasterizer import (  # noqa: E402
    stream_function as tfun)

SIZE = (32, 24)
HEUR = dict(compute_point_heuristic=True, compute_visibility=True)


def scene(num_features):
  packed, depths, _ = make_scene(0, 80, SIZE)
  feats = np.random.default_rng(1).uniform(
      0.0, 1.0, (80, num_features)).astype(np.float32)
  return np.asarray(packed), np.asarray(depths), feats


@pytest.mark.parametrize("num_features,tile_size", [(64, 8), (3, 4)])
def test_rasterize_and_gradients_match_jax(num_features, tile_size):
  packed, depths, feats = scene(num_features)
  config = RasterConfig(tile_size=tile_size, chunk_size=8, **HEUR)
  mj = jstream.stream_map(jnp.asarray(packed), jnp.asarray(depths),
                          jnp.asarray(feats), SIZE, config, group_width=2,
                          **TIGHT)
  assert int(mj.num_overflow) == 0
  tgt = np.random.default_rng(0).random((SIZE[1], SIZE[0],
                                         num_features)).astype(np.float32)

  def loss_j(p, f, pr):
    img, w = jfun.stream_rasterize_with_mapping(p, f, mj, SIZE, config,
                                                probe=pr)
    return jnp.sum((img - tgt) ** 2) + jnp.sum(w ** 2), (img, w)

  pw = jfun.probe_width(config)
  (_, (img_j, w_j)), want = jax.value_and_grad(
      loss_j, argnums=(0, 1, 2), has_aux=True)(
          jnp.asarray(packed), jnp.asarray(feats), jnp.zeros((80, pw)))
  assert float(np.abs(np.asarray(want[2])).max()) > 0.1

  mt = tstream.stream_map(pc.t(packed), pc.t(depths), pc.t(feats), SIZE,
                          pc.config(config), group_width=2, **TIGHT)
  assert int(mt.num_overflow) == 0
  for m in (pc.mapping(mj), mt):
    args = [pc.t(packed).requires_grad_(True),
            pc.t(feats).requires_grad_(True),
            torch.zeros((80, pw), requires_grad=True)]
    img, w = tfun.stream_rasterize_with_mapping(
        args[0], args[1], m, SIZE, pc.config(config), probe=args[2])
    assert img.shape == (SIZE[1], SIZE[0], num_features)
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(img_j),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(w_j),
                               atol=1e-5, rtol=1e-5)
    loss = ((img - torch.from_numpy(tgt)) ** 2).sum() + (w ** 2).sum()
    got = torch.autograd.grad(loss, args)
    for name, a, b in zip(("gaussians2d", "features", "probe"), got, want):
      np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                 rtol=1e-4, err_msg=name)
