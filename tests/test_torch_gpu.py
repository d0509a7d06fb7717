"""The port's CUDA kernels against their plain twins, on a CUDA device.

No JAX here: these tests run where the card is.  Without a CUDA device
every test skips.  On the card:  python -m pytest tests/test_torch_gpu.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpu_splatting_torch import RasterConfig, calibrate_stream, stream_map
from tpu_splatting_torch.rasterizer import stream_kernels as sk
from tpu_splatting_torch.scenes import uniform_scene

pytestmark = pytest.mark.gpu

MODES = {
    "blend": dict(),
    "blend_antialias": dict(antialias=True),
    "quantile": dict(use_alpha_blending=False, saturate_threshold=0.25),
    "quantile_antialias": dict(use_alpha_blending=False,
                               saturate_threshold=0.25, antialias=True),
}


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device")
  return torch.device("cuda")


BWD_MODES = {
    "blend": dict(),
    "antialias": dict(antialias=True),
    "heuristics": dict(compute_point_heuristic=True,
                       compute_visibility=True),
}


def mapping_for(dev, config, n=4000, size=(128, 96), depth_features=False):
  packed, depth, feats = (
      torch.from_numpy(x).to(dev)
      for x in uniform_scene(np.random.default_rng(0), n, size))
  if depth_features:
    feats = depth[:, None]
  cal = calibrate_stream(packed, depth, feats, size, config, group_width=8)
  m = stream_map(packed, depth, feats, size, config, group_width=8,
                 **{k: cal[k] for k in ("num_slabs", "strip_cap", "slab_cap",
                                        "w_max", "run_cap", "wide_cap",
                                        "dup_cap")})
  assert int(m.num_overflow) == 0
  return m


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("tile_size", [16, 8])
def test_kernel_matches_twin(cuda, mode, tile_size):
  config = RasterConfig(tile_size=tile_size, **MODES[mode])
  m = mapping_for(cuda, config,
                  depth_features=not config.use_alpha_blending)
  sk.reset_launch_counts()
  got = sk.stream_forward(m, config)
  torch.cuda.synchronize()
  assert sk.launch_counts["stream_forward"] == 1
  want = sk.stream_forward_reference(m, config)
  assert float(want.abs().max()) > 0.1
  torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def test_kernel_rejects_bad_inputs(cuda):
  config = RasterConfig()
  m = mapping_for(cuda, config)
  with pytest.raises(TypeError):
    sk.stream_forward(dataclasses.replace(m, desc=m.desc.long()), config)
  with pytest.raises(ValueError):
    sk.stream_forward(dataclasses.replace(m, strip_blk=m.strip_blk[:1]),
                      config)


def columns_close(got, want):
  """Per column: max |kernel - twin| <= 1e-4 * max |twin column| + 1e-6
  (the kernel's atomics sum in a varying order)."""
  tol = 1e-4 * want.abs().amax(0) + 1e-6
  err = (got - want).abs().amax(0)
  assert bool((err <= tol).all()), (err.tolist(), tol.tolist())


@pytest.mark.parametrize("mode", sorted(BWD_MODES))
@pytest.mark.parametrize("tile_size", [16, 8])
def test_backward_kernel_matches_twin(cuda, mode, tile_size):
  config = RasterConfig(tile_size=tile_size, **BWD_MODES[mode])
  m = mapping_for(cuda, config)
  img = sk.stream_forward(m, config)
  gen = torch.Generator(device=cuda).manual_seed(0)
  gimg = torch.randn(img.shape, generator=gen, device=cuda)
  sk.reset_launch_counts()
  got = sk.stream_backward(m, img, gimg, config)
  torch.cuda.synchronize()
  assert sk.launch_counts["stream_backward"] == 1
  want = sk.stream_backward_reference(m, img, gimg, config)
  assert got.shape == want.shape == (m.num_tiles * m.run_cap + 1,
                                     sk.slab_width(config, 3))
  assert float(want.abs().max()) > 0.1
  assert not bool(got[-1].any())
  columns_close(got, want)


def test_backward_kernel_rejects_bad_inputs(cuda):
  config = RasterConfig()
  m = mapping_for(cuda, config)
  img = sk.stream_forward(m, config)
  with pytest.raises(TypeError):
    sk.stream_backward(m, img, img.double(), config)
  with pytest.raises(ValueError):
    sk.stream_backward(m, img[:-1], img, config)
  with pytest.raises(ValueError):
    sk.stream_backward(m, img, img, dataclasses.replace(
        config, use_alpha_blending=False))


def test_cuda_step_never_takes_a_twin(cuda, monkeypatch):
  """Forward and backward of a CUDA render run the kernels only."""
  from tpu_splatting_torch.rasterizer.stream_function import (
      stream_rasterize_with_mapping)

  def refuse(*args, **kw):
    raise AssertionError("a CUDA tensor reached a plain twin")
  monkeypatch.setattr(sk, "stream_forward_reference", refuse)
  monkeypatch.setattr(sk, "stream_backward_reference", refuse)
  config = RasterConfig(compute_point_heuristic=True,
                        compute_visibility=True)
  m = mapping_for(cuda, config)
  n = m.num_points
  g2d = torch.zeros((n, 7), device=cuda, requires_grad=True)
  feats = torch.zeros((n, 3), device=cuda, requires_grad=True)
  probe = torch.zeros((n, 3), device=cuda, requires_grad=True)
  sk.reset_launch_counts()
  img, w = stream_rasterize_with_mapping(g2d, feats, m, (128, 96), config,
                                         probe=probe)
  (img.square().sum() + w.sum()).backward()
  assert sk.launch_counts == {"stream_forward": 1, "stream_backward": 1}
  assert float(probe.grad[:, 0].max()) > 0.0
  assert bool(torch.isfinite(g2d.grad).all())
