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


def splats(n, size, seed=0):
  """Uniform random 2D splats (packed 7-float rows), NDC depth, colours."""
  rng = np.random.default_rng(seed)
  w, h = size
  scale = 1.2 * w / (1 + np.sqrt(n))
  packed = np.zeros((n, 7), np.float32)
  packed[:, 0] = rng.uniform(0, w, n)
  packed[:, 1] = rng.uniform(0, h, n)
  theta = rng.uniform(0, np.pi, n)
  packed[:, 2], packed[:, 3] = np.cos(theta), np.sin(theta)
  packed[:, 4:6] = (rng.random((n, 2)) + 0.2) * scale
  packed[:, 6] = rng.uniform(0.1, 0.9, n)
  depth = rng.uniform(0.05, 0.95, n).astype(np.float32)
  feats = rng.random((n, 3)).astype(np.float32)
  return packed, depth, feats


def mapping_for(dev, config, n=4000, size=(128, 96), depth_features=False):
  packed, depth, feats = (torch.from_numpy(x).to(dev)
                          for x in splats(n, size))
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
