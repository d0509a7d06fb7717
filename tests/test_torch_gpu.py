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


def mapping_for(dev, config, n=4000, size=(128, 96), depth_features=False,
                num_features=None):
  packed, depth, feats = (
      torch.from_numpy(x).to(dev)
      for x in uniform_scene(np.random.default_rng(0), n, size))
  if depth_features:
    feats = depth[:, None]
  if num_features is not None:
    feats = torch.from_numpy(np.random.default_rng(1).uniform(
        0.0, 1.0, (n, num_features)).astype(np.float32)).to(dev)
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


def check_backward(dev, m, config):
  """K2 on a random cotangent against its twin, column by column."""
  img = sk.stream_forward(m, config)
  gen = torch.Generator(device=dev).manual_seed(0)
  gimg = torch.randn(img.shape, generator=gen, device=dev)
  sk.reset_launch_counts()
  got = sk.stream_backward(m, img, gimg, config)
  torch.cuda.synchronize()
  assert sk.launch_counts["stream_backward"] == 1
  want = sk.stream_backward_reference(m, img, gimg, config)
  assert got.shape == want.shape == (
      m.num_tiles * m.run_cap + 1, sk.slab_width(config, m.feature_size))
  assert float(want.abs().max()) > 0.1
  assert not bool(got[-1].any())
  columns_close(got, want)


@pytest.mark.parametrize("mode", sorted(BWD_MODES))
@pytest.mark.parametrize("tile_size", [16, 8])
def test_backward_kernel_matches_twin(cuda, mode, tile_size):
  config = RasterConfig(tile_size=tile_size, **BWD_MODES[mode])
  check_backward(cuda, mapping_for(cuda, config), config)


@pytest.mark.parametrize("num_features", [16, 40])
@pytest.mark.parametrize("tile_size", [16, 8])
def test_backward_kernel_wide_features(cuda, num_features, tile_size):
  """The 32-wide reductions: one batch (16 features, the 22-feature
  instantiation) and two batches (40 features, the 56-feature one)."""
  config = RasterConfig(tile_size=tile_size, **BWD_MODES["heuristics"])
  m = mapping_for(cuda, config, num_features=num_features)
  assert m.feature_size == num_features
  check_backward(cuda, m, config)


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
  # 16 pixels a tile are half a warp: no instantiation takes them
  half_warp = img[..., :16].contiguous()
  with pytest.raises(ValueError, match="instantiation"):
    sk.stream_backward(m, half_warp, half_warp,
                       dataclasses.replace(config, tile_size=4))


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


# --- the sorted-overlap pipeline: K4, K5, K6, K7 ---------------------------

SORTED_MODES = {
    "blend": dict(),
    "antialias": dict(antialias=True),
    "quantile": dict(use_alpha_blending=False, saturate_threshold=0.25),
}


def sorted_mapping_for(dev, config, n=4000, size=(128, 96),
                       depth_features=False):
  from tpu_splatting_torch import map_to_tiles
  from tpu_splatting_torch.mapper.tile_mapper import calibrate_mapper
  packed, depth, feats = (
      torch.from_numpy(x).to(dev)
      for x in uniform_scene(np.random.default_rng(0), n, size))
  if depth_features:
    feats = depth[:, None]
  cal = calibrate_mapper(packed, depth, size, config)
  config = dataclasses.replace(config, tile_window=cal["tile_window"],
                               big_capacity=cal["big_capacity"])
  m = map_to_tiles(packed, depth, size, config,
                   max_overlaps=cal["max_overlaps"], features=feats)
  assert int(m.num_overflow) == 0
  return m, config


@pytest.mark.parametrize("mode", sorted(SORTED_MODES))
@pytest.mark.parametrize("tile_size", [16, 8])
def test_sorted_forward_kernel_matches_twin(cuda, mode, tile_size):
  from tpu_splatting_torch.rasterizer import kernels as kk
  config = RasterConfig(tile_size=tile_size, **SORTED_MODES[mode])
  m, config = sorted_mapping_for(cuda, config,
                                 depth_features=not config.use_alpha_blending)
  args = (m.sorted_payload, m.chunk_src, m.chunk_cnt, m.chunk_to_tile,
          config, m.num_tiles, m.tiles_wide)
  kk.reset_launch_counts()
  img, vis = kk.forward(*args)
  torch.cuda.synchronize()
  assert kk.launch_counts["sorted_forward"] == 1
  img_t, vis_t = kk.forward_reference(*args)
  assert float(img_t.abs().max()) > 0.1
  torch.testing.assert_close(img, img_t, atol=1e-4, rtol=0)
  assert float((vis - vis_t).abs().max()) <= 1e-4 * float(
      vis_t.abs().max()) + 1e-6


@pytest.mark.parametrize("mode", sorted(BWD_MODES))
@pytest.mark.parametrize("tile_size", [16, 8])
def test_sorted_backward_kernel_matches_twin(cuda, mode, tile_size):
  from tpu_splatting_torch.rasterizer import kernels as kk
  config = RasterConfig(tile_size=tile_size, **BWD_MODES[mode])
  m, config = sorted_mapping_for(cuda, config)
  img, _ = kk.forward(m.sorted_payload, m.chunk_src, m.chunk_cnt,
                      m.chunk_to_tile, config, m.num_tiles, m.tiles_wide,
                      with_vis=False)
  gen = torch.Generator(device=cuda).manual_seed(0)
  gimg = torch.randn(img.shape, generator=gen, device=cuda)
  args = (m.sorted_payload, img, gimg, m.chunk_src, m.chunk_cnt,
          m.chunk_to_tile, config, m.num_tiles, m.tiles_wide)
  kk.reset_launch_counts()
  got = kk.backward(*args)
  torch.cuda.synchronize()
  assert kk.launch_counts["sorted_backward"] == 1
  want = kk.backward_reference(*args)
  assert float(want.abs().max()) > 0.1
  columns_close(got, want)


def test_layout_kernels_match_twins(cuda):
  from tpu_splatting_torch.rasterizer import layout
  m, _ = sorted_mapping_for(cuda, RasterConfig())
  layout.reset_launch_counts()
  for rows in (m.sorted_payload, m.overlap_to_point,
               m.sorted_payload.double()):
    got = layout.window_copy(rows, m.chunk_src, m.chunk_cnt, m.chunk_size)
    want = layout.window_copy_reference(rows, m.chunk_src, m.chunk_cnt,
                                        m.chunk_size)
    assert torch.equal(got, want)
  gen = torch.Generator(device=cuda).manual_seed(1)
  n = 5000
  ids = torch.sort(torch.randint(0, n + 40, (60000,), generator=gen,
                                 device=cuda)).values.to(torch.int32)
  for c in (1, 12, 40):
    rows = torch.randn((ids.shape[0], c), generator=gen, device=cuda)
    got = layout.segment_sum_sorted(rows, ids, n)
    want = layout.segment_sum_sorted_reference(rows, ids, n)
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.abs().max()) + 1e-6
  assert layout.launch_counts == {"window_copy": 3, "segment_sum_sorted": 3}
  with pytest.raises(TypeError):
    layout.segment_sum_sorted(rows, ids.long(), n)


@pytest.mark.parametrize("columns", [1, 12])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32,
                                   torch.float64])
def test_window_copy_kernel_edge_windows(cuda, columns, dtype):
  """K6 bit for bit against its twin on empty, full and ragged windows and
  on windows that end on the last row of ``rows``."""
  from tpu_splatting_torch.rasterizer import layout
  rng = np.random.default_rng(3)
  g, m, k = 128, 5000, 300
  shape = (m,) if columns == 1 else (m, columns)
  rows = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, shape)
                          .astype(np.int64)).to(cuda)
  rows = rows.to(dtype) if dtype != torch.float64 else rows.double() / 7
  cnt = rng.integers(1, g, k)
  cnt[0::5] = 0                      # empty
  cnt[1::5] = g                      # full
  src = rng.integers(0, m - g + 1, k)
  src[2::5] = m - cnt[2::5]          # ragged, ending on the last row
  src[3::5] = m - g                  # full or ragged near the end
  cnt[3::5] = g
  src[-1], cnt[-1] = m - g, g        # the last window ends on the last row
  src_t, cnt_t = (torch.from_numpy(x.astype(np.int32)).to(cuda)
                  for x in (src, cnt))
  layout.reset_launch_counts()
  got = layout.window_copy(rows, src_t, cnt_t, g)
  want = layout.window_copy_reference(rows, src_t, cnt_t, g)
  torch.cuda.synchronize()
  assert layout.launch_counts["window_copy"] == 1
  assert got.dtype == dtype and got.shape == (k * g, *shape[1:])
  assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


def test_sorted_step_never_takes_a_twin(cuda, monkeypatch):
  """Forward (with visibility) and backward of a CUDA render on the sorted
  pipeline run K4, K5, K6 and K7 only."""
  from tpu_splatting_torch import rasterize
  from tpu_splatting_torch.rasterizer import kernels as kk
  from tpu_splatting_torch.rasterizer import layout

  def refuse(*args, **kw):
    raise AssertionError("a CUDA tensor reached a plain twin")
  for mod, name in ((kk, "forward_reference"), (kk, "backward_reference"),
                    (layout, "window_copy_reference"),
                    (layout, "segment_sum_sorted_reference")):
    monkeypatch.setattr(mod, name, refuse)
  config = RasterConfig(pipeline="sorted", compute_point_heuristic=True,
                        compute_visibility=True)
  packed, depth, feats = (
      torch.from_numpy(x).to(cuda)
      for x in uniform_scene(np.random.default_rng(0), 4000, (128, 96)))
  g2d = packed.clone().requires_grad_(True)
  probe = torch.zeros((4000, 2), device=cuda, requires_grad=True)
  kk.reset_launch_counts()
  layout.reset_launch_counts()
  out = rasterize(g2d, depth, feats, (128, 96), config, max_overlaps=200000,
                  heuristic_probe=probe)
  assert int(out.num_overflow) == 0
  (out.image.square().sum() + out.image_weight.sum()).backward()
  assert kk.launch_counts == {"sorted_forward": 1, "sorted_backward": 1}
  assert layout.launch_counts == {"window_copy": 2, "segment_sum_sorted": 2}
  assert float(out.visibility.max()) > 0.0
  assert bool(torch.isfinite(g2d.grad).all())
  assert float(probe.grad[:, 0].max()) > 0.0
