"""The port's CUDA kernels against their plain twins, on a CUDA device.

No JAX here: these tests run where the card is.  Without a CUDA device
every test skips.  On the card:  python -m pytest tests/test_torch_gpu.py
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from tpu_splatting_torch import RasterConfig, calibrate_stream, stream_map
from tpu_splatting_torch.parallel.mesh import make_mesh
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


def random_features(dev, n, num_features):
  return torch.from_numpy(np.random.default_rng(1).uniform(
      0.0, 1.0, (n, num_features)).astype(np.float32)).to(dev)


def mapping_for(dev, config, n=4000, size=(128, 96), depth_features=False,
                num_features=None, slab_cap=512, group_width=8):
  packed, depth, feats = (
      torch.from_numpy(x).to(dev)
      for x in uniform_scene(np.random.default_rng(0), n, size))
  if depth_features:
    feats = depth[:, None]
  if num_features is not None:
    feats = random_features(dev, n, num_features)
  cal = calibrate_stream(packed, depth, feats, size, config,
                         group_width=group_width, slab_cap=slab_cap)
  m = stream_map(packed, depth, feats, size, config, group_width=group_width,
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
  # 16 pixels a tile (half a warp) render: the block is padded with
  # frozen lanes
  config4 = dataclasses.replace(config, tile_size=4)
  check_backward(cuda, mapping_for(cuda, config4), config4)


def test_backward_kernel_rejects_rows_past_int32(cuda):
  """K2 numbers its gradient-buffer rows (homes x run_cap) in 32-bit ints:
  a mapping whose buffer would pass 2^31 rows raises on the host."""
  config = RasterConfig()
  m = mapping_for(cuda, config)
  img = sk.stream_forward(m, config)
  big = dataclasses.replace(m, run_cap=(1 << 31) // m.num_tiles + 1)
  with pytest.raises(ValueError, match="32-bit"):
    sk.stream_backward(big, img, img, config)


# Past the headline's shapes: feature counts above the largest register
# instantiation (56: the generic one), tiles that are not whole warps
# (tile 4), tiles of more than 256 pixels (tile 32: the generic one), with
# the capacities the kernels' shared memory holds.  (features, tile_size,
# stream slab_cap, stream group width, sorted chunk_size)
SHAPES = [(3, 4, 512, 8, 128), (64, 4, 128, 8, 128), (56, 16, 128, 8, 128),
          (57, 16, 128, 8, 128), (64, 16, 128, 8, 128),
          (100, 8, 128, 8, 32), (100, 16, 128, 8, 32), (3, 32, 512, 4, 128)]
# K5's other register instantiations, <23, 32> and <56, 32> (K2's are
# covered by test_backward_kernel_wide_features)
SORTED_SHAPES = SHAPES + [(16, 8, 0, 0, 128), (40, 16, 0, 0, 128)]


def shape_id(shape):
  return f"F{shape[0]}-tile{shape[1]}"


@pytest.mark.parametrize("shape", SHAPES, ids=shape_id)
def test_stream_kernels_any_shape(cuda, shape):
  """K1 (blending) and K2 (heuristics) against their twins."""
  num_features, tile_size, slab_cap, group_width, _ = shape
  config = RasterConfig(tile_size=tile_size, **BWD_MODES["heuristics"])
  m = mapping_for(cuda, config, num_features=num_features,
                  slab_cap=slab_cap, group_width=group_width)
  sk.reset_launch_counts()
  got = sk.stream_forward(m, config)
  torch.cuda.synchronize()
  assert sk.launch_counts["stream_forward"] == 1
  want = sk.stream_forward_reference(m, config)
  assert float(want.abs().max()) > 0.1
  torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
  check_backward(cuda, m, config)


def test_stream_kernels_raise_only_past_shared_memory(cuda):
  """At 100 features a slab of 2048 rows needs more shared memory than
  one block has: both kernels raise ValueError with the bytes."""
  config = RasterConfig(**BWD_MODES["heuristics"])
  m = mapping_for(cuda, config, num_features=100, slab_cap=128)
  img = sk.stream_forward(m, config)
  big = dataclasses.replace(m, slab_cap=2048)
  with pytest.raises(ValueError, match=r"needs \d+ B of shared memory"):
    sk.stream_forward(big, config)
  with pytest.raises(ValueError, match=r"needs \d+ B of shared memory"):
    sk.stream_backward(big, img, img, config)


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
  assert sk.launch_counts == {"stream_forward": 1, "stream_backward": 1,
                              "halo_merge": 0}
  assert float(probe.grad[:, 0].max()) > 0.0
  assert bool(torch.isfinite(g2d.grad).all())


# --- the sorted-overlap pipeline: K4, K5, K6, K7 ---------------------------

SORTED_MODES = {
    "blend": dict(),
    "antialias": dict(antialias=True),
    "quantile": dict(use_alpha_blending=False, saturate_threshold=0.25),
}


def sorted_mapping_for(dev, config, n=4000, size=(128, 96),
                       depth_features=False, num_features=None):
  from tpu_splatting_torch import map_to_tiles
  from tpu_splatting_torch.mapper.tile_mapper import calibrate_mapper
  packed, depth, feats = (
      torch.from_numpy(x).to(dev)
      for x in uniform_scene(np.random.default_rng(0), n, size))
  if depth_features:
    feats = depth[:, None]
  if num_features is not None:
    feats = random_features(dev, n, num_features)
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


def check_sorted_backward(dev, m, config):
  """K5 on a random cotangent against its twin, column by column."""
  from tpu_splatting_torch.rasterizer import kernels as kk
  img, _ = kk.forward(m.sorted_payload, m.chunk_src, m.chunk_cnt,
                      m.chunk_to_tile, config, m.num_tiles, m.tiles_wide,
                      with_vis=False)
  gen = torch.Generator(device=dev).manual_seed(0)
  gimg = torch.randn(img.shape, generator=gen, device=dev)
  args = (m.sorted_payload, img, gimg, m.chunk_src, m.chunk_cnt,
          m.chunk_to_tile, config, m.num_tiles, m.tiles_wide)
  kk.reset_launch_counts()
  got = kk.backward(*args)
  torch.cuda.synchronize()
  assert kk.launch_counts["sorted_backward"] == 1
  want = kk.backward_reference(*args)
  assert float(want.abs().max()) > 0.1
  columns_close(got, want)


@pytest.mark.parametrize("mode", sorted(BWD_MODES))
@pytest.mark.parametrize("tile_size", [16, 8])
def test_sorted_backward_kernel_matches_twin(cuda, mode, tile_size):
  config = RasterConfig(tile_size=tile_size, **BWD_MODES[mode])
  m, config = sorted_mapping_for(cuda, config)
  check_sorted_backward(cuda, m, config)


@pytest.mark.parametrize("shape", SORTED_SHAPES, ids=shape_id)
def test_sorted_kernels_any_shape(cuda, shape):
  """K4 (blending, with visibility) and K5 in blending, antialias and
  heuristics modes against their twins."""
  from tpu_splatting_torch.rasterizer import kernels as kk
  num_features, tile_size, _, _, chunk = shape
  config = RasterConfig(tile_size=tile_size, chunk_size=chunk)
  m, config = sorted_mapping_for(cuda, config, num_features=num_features)
  assert m.feature_size == num_features
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
  for mode in sorted(BWD_MODES):
    check_sorted_backward(cuda, m, dataclasses.replace(config,
                                                       **BWD_MODES[mode]))


def test_sorted_kernels_raise_only_past_shared_memory(cuda):
  """At 100 features chunks of 2048 rows need more shared memory than one
  block has: K4 and K5 raise ValueError with the bytes."""
  from tpu_splatting_torch.rasterizer import kernels as kk
  config = RasterConfig(chunk_size=32, **BWD_MODES["heuristics"])
  m, config = sorted_mapping_for(cuda, config, num_features=100)
  img, _ = kk.forward(m.sorted_payload, m.chunk_src, m.chunk_cnt,
                      m.chunk_to_tile, config, m.num_tiles, m.tiles_wide)
  big = dataclasses.replace(config, chunk_size=2048)
  with pytest.raises(ValueError, match=r"needs \d+ B of shared memory"):
    kk.forward(m.sorted_payload, m.chunk_src, m.chunk_cnt, m.chunk_to_tile,
               big, m.num_tiles, m.tiles_wide)
  with pytest.raises(ValueError, match=r"needs \d+ B of shared memory"):
    kk.backward(m.sorted_payload, img, img, m.chunk_src, m.chunk_cnt,
                m.chunk_to_tile, big, m.num_tiles, m.tiles_wide)


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
  with pytest.raises(TypeError):       # the order is torch.sort's int64
    layout.segment_sum_sorted(rows, ids, n, order=torch.arange(
        ids.shape[0], dtype=torch.int32, device=cuda))


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
  pipeline run K4, K5, K6 and K7 only: K6 once, for the one sort of the
  point ids that both reduces share."""
  from tpu_splatting_torch import rasterize
  from tpu_splatting_torch.rasterizer import function as fn
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
  fn.sort_counts["point_ids"] = 0
  out = rasterize(g2d, depth, feats, (128, 96), config, max_overlaps=200000,
                  heuristic_probe=probe)
  assert int(out.num_overflow) == 0
  (out.image.square().sum() + out.image_weight.sum()).backward()
  assert kk.launch_counts == {"sorted_forward": 1, "sorted_backward": 1}
  assert layout.launch_counts == {"window_copy": 1, "segment_sum_sorted": 2}
  assert fn.sort_counts["point_ids"] == 1
  assert float(out.visibility.max()) > 0.0
  assert bool(torch.isfinite(g2d.grad).all())
  assert float(probe.grad[:, 0].max()) > 0.0


# --- the forward kernels' per-warp walk and floor probes (K1, K4) ---------

def edge_scene(dev, n=3000, size=(128, 96)):
  """Isotropic splats placed so that a pixel centre sits at the threshold
  radius sigma * sqrt(2 ln(alpha / alpha_threshold)) from the mean, moved
  by -1e-6, 0 or +1e-6 of it: their footprints' edges fall on pixel
  centres, in random directions across the warps' rectangles."""
  rng = np.random.default_rng(9)
  thr = RasterConfig().alpha_threshold
  centre = np.stack([rng.integers(0, size[0], n), rng.integers(0, size[1],
                                                               n)], 1) + 0.5
  sigma = rng.uniform(0.3, 3.0, n)
  alpha = rng.uniform(0.05, 0.9, n)
  radius = sigma * np.sqrt(2.0 * np.log(alpha / thr))
  radius *= 1.0 + rng.choice([-1e-6, 0.0, 1e-6], n)
  ang = rng.uniform(0.0, 2.0 * np.pi, n)
  packed = np.stack([centre[:, 0] + radius * np.cos(ang),
                     centre[:, 1] + radius * np.sin(ang),
                     np.cos(ang), np.sin(ang), sigma, sigma, alpha],
                    1).astype(np.float32)
  depth = rng.uniform(0.05, 0.95, n).astype(np.float32)
  feats = rng.random((n, 3)).astype(np.float32)
  return (torch.from_numpy(x).to(dev) for x in (packed, depth, feats))


@pytest.mark.parametrize("mode", ["blend", "quantile"])
def test_forward_kernels_at_footprint_edges(cuda, mode):
  """K1 and K4 against their twins where rows' footprint edges fall on
  pixel centres: a row skipped that should be walked moves a pixel by
  about alpha_threshold, far past the tolerance."""
  from tpu_splatting_torch import map_to_tiles
  from tpu_splatting_torch.rasterizer import kernels as kk
  size = (128, 96)
  config = RasterConfig(**MODES[mode])
  packed, depth, feats = edge_scene(cuda)
  if not config.use_alpha_blending:
    feats = depth[:, None]
  cal = calibrate_stream(packed, depth, feats, size, config, group_width=8)
  m = stream_map(packed, depth, feats, size, config, group_width=8,
                 **{k: cal[k] for k in ("num_slabs", "strip_cap", "slab_cap",
                                        "w_max", "run_cap", "wide_cap",
                                        "dup_cap")})
  assert int(m.num_overflow) == 0
  torch.testing.assert_close(sk.stream_forward(m, config),
                             sk.stream_forward_reference(m, config),
                             atol=1e-4, rtol=0)
  tm = map_to_tiles(packed, depth, size, config, max_overlaps=200_000,
                    features=feats)
  assert int(tm.num_overflow) == 0
  args = (tm.sorted_payload, tm.chunk_src, tm.chunk_cnt, tm.chunk_to_tile,
          config, tm.num_tiles, tm.tiles_wide)
  img, vis = kk.forward(*args)
  img_t, vis_t = kk.forward_reference(*args)
  torch.testing.assert_close(img, img_t, atol=1e-4, rtol=0)
  assert float((vis - vis_t).abs().max()) <= 1e-4 * float(
      vis_t.abs().max()) + 1e-6


def test_floor_probes_match_plain(cuda):
  """Both floor probes bit for bit against their plain versions, counted
  apart from the path's kernels; the sorted one is built for the <4>
  instantiation only."""
  from tpu_splatting_torch.rasterizer import kernels as kk
  config = RasterConfig()
  m = mapping_for(cuda, config)
  sk.reset_launch_counts()
  assert torch.equal(sk.stream_forward_floor(m, config),
                     sk.stream_forward_floor_reference(m, config))
  assert sk.probe_launch_counts["stream_forward_floor"] == 1
  assert sum(sk.probe_launch_counts.values()) == 1
  assert sk.launch_counts["stream_forward"] == 0
  tm, config = sorted_mapping_for(cuda, config)
  args = (tm.sorted_payload, tm.chunk_src, tm.chunk_cnt, tm.chunk_to_tile,
          config, tm.num_tiles, tm.tiles_wide)
  kk.reset_launch_counts()
  assert torch.equal(kk.forward_floor(*args), kk.forward_floor_reference(*args))
  assert kk.probe_launch_counts == {"sorted_forward_floor": 1}
  with pytest.raises(ValueError, match="floor probe"):
    kk.forward_floor(*args[:4], dataclasses.replace(config, tile_size=4),
                     *args[5:])



# --- the profiling modes of K1 and K2 (stream_kernels' ablate, counts) ------

@pytest.mark.parametrize("ablate, with_counts", [
    ("", True), ("skeleton", False), ("skeleton", True),
    ("no_assemble", False), ("no_assemble", True), ("no_sort", False),
    ("no_mask", True), ("no_alpha", False), ("no_alpha", True)])
def test_forward_profiling_modes_match_twins(cuda, ablate, with_counts):
  """Each K1 profiling mode against its twin at
  ``stream_kernels.profile_gate`` (the floor probe's bit for bit,
  no_alpha's faint image per channel relative to its largest value, the
  others at K1's gate), the counts exactly, counted apart from the path's
  launches."""
  config = RasterConfig()
  m = mapping_for(cuda, config)
  sk.reset_launch_counts()
  got = sk.stream_forward(m, config, ablate=ablate, with_counts=with_counts)
  torch.cuda.synchronize()
  want = sk.stream_forward_reference(m, config, ablate=ablate,
                                     with_counts=with_counts)
  mode = sk.ABLATION_ALIASES.get(ablate, ablate)
  assert sk.launch_counts["stream_forward"] == 0
  assert sk.probe_launch_counts[f"stream_forward_{mode or 'counts'}"] == 1
  assert sk.probe_launch_counts["stream_forward_counts"] == int(with_counts)
  if with_counts:
    (got, counts), (want, want_counts) = got, want
    assert torch.equal(counts, want_counts)
    assert float(counts[1::8, 0].sum()) > 0
  # no_alpha's alphas are 1e-6 x a pixel coordinate: a faint image
  assert float(want.abs().max()) > (1e-3 if mode == "no_alpha" else 0.1)
  err, used = sk.profile_gate(got, want, "stream_forward", ablate)
  assert used <= 1.0, (err, used)


@pytest.mark.parametrize("ablate", ["skeleton", "no_sort", "no_mask",
                                    "no_grad", "no_copyback"])
def test_backward_profiling_modes_match_twins(cuda, ablate):
  config = RasterConfig(compute_point_heuristic=True, compute_visibility=True)
  m = mapping_for(cuda, config)
  img = sk.stream_forward(m, config)
  gimg = torch.randn(img.shape, device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(0))
  sk.reset_launch_counts()
  got = sk.stream_backward(m, img, gimg, config, ablate=ablate)
  torch.cuda.synchronize()
  mode = sk.ABLATION_ALIASES.get(ablate, ablate)
  assert sk.launch_counts["stream_backward"] == 0
  assert sk.probe_launch_counts[f"stream_backward_{mode}"] == 1
  want = sk.stream_backward_reference(m, img, gimg, config, ablate=ablate)
  err, used = sk.profile_gate(got, want, "stream_backward", ablate)
  assert used <= 1.0, (err, used)


def test_profiling_modes_reject_other_instantiations(cuda):
  """The modes are built for K1 <4> and K2 <6, 16> only, unsharded."""
  config = RasterConfig()
  wide = mapping_for(cuda, config, num_features=8)
  with pytest.raises(ValueError, match="profiling modes"):
    sk.stream_forward(wide, config, with_counts=True)
  with pytest.raises(ValueError, match="profiling modes"):
    sk.stream_forward(wide, config, ablate="no_alpha")
  m = mapping_for(cuda, config)
  img = sk.stream_forward(m, config)
  with pytest.raises(ValueError, match="profiling modes"):
    sk.stream_forward(m, config, band0=1, ablate="no_sort")
  with pytest.raises(ValueError, match="profiling modes"):
    sk.stream_backward(m, img, img, config, band0=0, halo=True,
                       ablate="no_grad")
  wide = mapping_for(cuda, config, num_features=7)
  img = sk.stream_forward(wide, config)
  with pytest.raises(ValueError, match="profiling modes"):
    sk.stream_backward(wide, img, img, config, ablate="skeleton")
  with pytest.raises(ValueError, match="unknown ablate"):
    sk.stream_forward(m, config, ablate="no_grad")


@pytest.mark.parametrize("backward", [False, True])
def test_bench_stream_profiles_on_card(cuda, backward, capsys):
  """bench_stream's profile at a small scene with the profile's config
  and group width: the counts line, then every mode with its device time
  and each difference full - mode with what it measures."""
  from tpu_splatting_torch.benchmarks import bench_stream
  s = bench_stream.setup(20_000, (256, 192), 1.2, 8 if backward else 4,
                         config=bench_stream.profile_config(backward),
                         device=cuda)
  prof = bench_stream.profile(s, backward, iters=1, reps=3)
  out = capsys.readouterr().out
  assert "# ACTIVE SLAB ITERS:" in out and "walked (row, warp) pairs" in out
  modes, phases = ((bench_stream.BWD_PROFILE, bench_stream.BWD_PHASES)
                   if backward else
                   (bench_stream.FWD_PROFILE, bench_stream.FWD_PHASES))
  assert set(prof["modes"]) == set(modes)
  for ab in modes:
    assert f"ablate={ab or 'none'}" in out, ab
    assert prof["modes"][ab]["device_ms"] > 0.0, ab
  for ab, what in phases.items():
    assert f"# full - {ab} = " in out and what in out, ab
    assert prof["modes"][ab]["measures"] == what


# --- K7 through the sort's order, and the row-gather probe -----------------

def reduce_case(dev, case, m=60_000, n=5_000):
  """(ids, order) of m chunk slots: the point ids sorted stably and the
  permutation, null slots (id n) included, as the sorted reduce sorts
  them; "heavy": one id owns most slots; "gaps": runs of 100 to 2,000
  empty ids and ids below 0 (dropped)."""
  rng = np.random.default_rng(len(case))
  if case == "uniform":
    pid = rng.integers(0, n, m)
  elif case == "heavy":
    pid = np.where(rng.random(m) < 0.7, 11, rng.integers(0, n, m))
  else:
    pid = rng.choice(np.arange(-3, n, 2_000 // 3 * 3 + 1), m)
    pid[:100] = rng.integers(0, 100, 100)
  pid[rng.random(m) < 0.3] = n
  ids, order = torch.sort(torch.from_numpy(pid.astype(np.int32)).to(dev),
                          stable=True)
  return ids, order


@pytest.mark.parametrize("case", ["uniform", "heavy", "gaps"])
@pytest.mark.parametrize("c", [1, 6, 12, 21])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_segment_sum_through_order(cuda, case, c, dtype):
  """K7 reading its rows through the order: bit for bit the unfused call
  on rows[order] and a second run; within 1e-5 * max + 1e-6 of its twin
  per column.  The twin's index_add_ sums on the card
  with atomics, in a varying order: f32 rows are multiples of 2^-8 below
  2^4, so every order sums the ~42,000 rows of the heavy segment exactly
  and the comparison checks which rows each segment sums; f64 rows are
  normal."""
  from tpu_splatting_torch.rasterizer import layout
  n = 5_000
  ids, order = reduce_case(cuda, case, n=n)
  gen = torch.Generator(device=cuda).manual_seed(c)
  rows = torch.randn((ids.shape[0], c), generator=gen, device=cuda,
                     dtype=dtype)
  if dtype == torch.float32:
    rows = torch.round(rows * 256) / 256
  layout.reset_launch_counts()
  got = layout.segment_sum_sorted(rows, ids, n, order=order)
  assert layout.launch_counts["segment_sum_sorted"] == 1
  for other in (layout.segment_sum_sorted(rows[order], ids, n),
                layout.segment_sum_sorted(rows, ids, n, order=order)):
    assert torch.equal(got.view(torch.uint8), other.view(torch.uint8))
  want = layout.segment_sum_sorted_reference(rows, ids, n, order=order)
  tol = 1e-5 * want.abs().amax(0) + 1e-6
  assert bool(((got - want).abs().amax(0) <= tol).all())


def test_segment_sum_element_path_matches_float4(cuda):
  """Rows that are not 16-byte aligned take the element path at C 12: the
  same sums, bit for bit."""
  from tpu_splatting_torch.rasterizer import layout
  ids, order = reduce_case(cuda, "uniform")
  gen = torch.Generator(device=cuda).manual_seed(3)
  flat = torch.randn(ids.shape[0] * 12 + 1, generator=gen, device=cuda)
  shifted = flat[1:].view(-1, 12)
  assert shifted.data_ptr() % 16 != 0
  aligned = shifted.clone()
  got = layout.segment_sum_sorted(shifted, ids, 5_000, order=order)
  want = layout.segment_sum_sorted(aligned, ids, 5_000, order=order)
  assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("ids, n", [
    ([7, 7, 7], 3),                  # every row past the last segment
    ([-2, -1, 0, 0, 40_000], 50_000),  # ids below 0; one run of 39,999
    ([0], 1), ([3], 1_000)])
def test_segment_sum_bounds_edges(cuda, ids, n):
  """The bounds pass at its edges: empty sums are 0, ids outside [0, n)
  are dropped, long runs of empty segments are written by a warp."""
  from tpu_splatting_torch.rasterizer import layout
  ids_t = torch.tensor(ids, dtype=torch.int32, device=cuda)
  rows = torch.arange(1, 3 * len(ids) + 1, dtype=torch.float32,
                      device=cuda).view(-1, 3)
  order = torch.arange(len(ids), device=cuda).flip(0)
  got = layout.segment_sum_sorted(rows, ids_t, n, order=order)
  want = layout.segment_sum_sorted_reference(rows, ids_t, n, order=order)
  assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(3000, 16), (3000, 12), (3000, 3),
                                   (3000,)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.int32])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_row_gather_kernel_matches_twin(cuda, shape, dtype, idx_dtype):
  """The row-gather probe bit for bit against its twin, indices outside
  the table included (0 there); counted as a probe."""
  from tpu_splatting_torch.rasterizer import layout
  rng = np.random.default_rng(5)
  n, a = shape[0], 20_000
  table = torch.from_numpy(rng.random(shape) * 1e4).to(cuda).to(dtype)
  idx = rng.integers(0, n, a)
  idx[::37] = rng.choice([-1, -n, n, 2 ** 31 - 1], len(idx[::37]))
  idx = torch.from_numpy(idx).to(cuda).to(idx_dtype)
  layout.reset_launch_counts()
  got = layout.row_gather(table, idx)
  want = layout.row_gather_reference(table, idx)
  torch.cuda.synchronize()
  assert layout.probe_launch_counts == {"row_gather": 1}
  assert layout.launch_counts["segment_sum_sorted"] == 0
  assert got.dtype == dtype and got.shape == (a, *shape[1:])
  assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


def test_sorted_reduce_sorts_once_and_never_searches(cuda, monkeypatch):
  """One training step's visibility reduce and backward share one sort
  of the point ids, and the reduce calls no torch.searchsorted."""
  from tpu_splatting_torch import map_to_tiles
  from tpu_splatting_torch.rasterizer import function as fn
  from tpu_splatting_torch.rasterizer import layout
  size = (128, 96)
  config = RasterConfig(pipeline="sorted", compute_point_heuristic=True,
                        compute_visibility=True)
  packed, depth, feats = (
      torch.from_numpy(x).to(cuda)
      for x in uniform_scene(np.random.default_rng(0), 4000, size))
  m = map_to_tiles(packed, depth, size, config, max_overlaps=200_000,
                   features=feats)
  searchsorted = torch.searchsorted

  def no_search_in_reduce(*args, **kw):
    assert not in_reduce, "the reduce called torch.searchsorted"
    return searchsorted(*args, **kw)
  reduce = fn.reduce_chunked_to_points
  in_reduce = False

  def watched_reduce(*args):
    nonlocal in_reduce
    in_reduce = True
    try:
      return reduce(*args)
    finally:
      in_reduce = False
  monkeypatch.setattr(torch, "searchsorted", no_search_in_reduce)
  monkeypatch.setattr(fn, "reduce_chunked_to_points", watched_reduce)
  g2d = packed.clone().requires_grad_(True)
  fn.sort_counts["point_ids"] = 0
  layout.reset_launch_counts()
  out = fn.rasterize_with_tiles(g2d, feats, m, size, config)
  out.image.square().sum().backward()
  assert fn.sort_counts["point_ids"] == 1
  assert layout.launch_counts == {"window_copy": 1, "segment_sum_sorted": 2}
  assert bool(torch.isfinite(g2d.grad).all())


# --- band sharding: K1 and K2 with band0, K2's halo buffer, the halo merge -


def shard_mapping(dev, config, n_shards=4):
  """A 4000-splat mapping of 8 bands and its shards' local mappings."""
  from tpu_splatting_torch.parallel import stream_sharded as ss
  m = mapping_for(dev, config, size=(128, 128))
  th_local, shards = ss._shards(m, make_mesh(n_shards,
                                             devices=[dev] * n_shards))
  return m, th_local, shards


@pytest.mark.parametrize("mode", ["blend", "heuristics"])
def test_band0_kernels_match_twins(cuda, mode):
  """On 4 virtual shards of one card: K1 with band0 against its twin and
  bit for bit the unsharded image's bands; K2 in halo mode against its
  twin, column by column."""
  config = RasterConfig(**BWD_MODES[mode])
  m, th_local, shards = shard_mapping(cuda, config)
  full = sk.stream_forward(m, config)
  t_local = m.tiles_wide * th_local
  gen = torch.Generator(device=cuda).manual_seed(3)
  gimg = torch.randn(full.shape, generator=gen, device=cuda)
  for d, band0, _, lm in shards:
    sk.reset_launch_counts()
    img = sk.stream_forward(lm, config, band0)
    torch.cuda.synchronize()
    assert sk.launch_counts["stream_forward"] == 1
    torch.testing.assert_close(
        img, sk.stream_forward_reference(lm, config, band0), atol=1e-4,
        rtol=0)
    assert torch.equal(img, full[d * t_local:(d + 1) * t_local])
    g = gimg[d * t_local:(d + 1) * t_local]
    got = sk.stream_backward(lm, img, g, config, band0, halo=True)
    torch.cuda.synchronize()
    assert sk.launch_counts["stream_backward"] == 1
    want = sk.stream_backward_reference(lm, img, g, config, band0, halo=True)
    assert got.shape == want.shape == (
        (m.tiles_wide * (th_local + 2)) * m.run_cap + 1,
        sk.slab_width(config, m.feature_size))
    assert float(want.abs().max()) > 0.1
    assert not bool(got[-1].any())
    columns_close(got, want)


@pytest.mark.parametrize("th_local", [1, 3])
@pytest.mark.parametrize("peers", ["both", "above", "below", "none"])
def test_halo_merge_kernel_matches_twin(cuda, th_local, peers):
  """Bit for bit its plain twin, in place, for a shard with both peers,
  with no upper or no lower peer, and with neither."""
  band_rows, slabw = 1000, 13
  gen = torch.Generator(device=cuda).manual_seed(4)
  buf = torch.randn(((th_local + 2) * band_rows + 1, slabw), generator=gen,
                    device=cuda)
  above = torch.randn((band_rows, slabw), generator=gen, device=cuda)
  below = torch.randn((band_rows, slabw), generator=gen, device=cuda)
  above = above if peers in ("both", "above") else None
  below = below if peers in ("both", "below") else None
  want_buf = buf.clone()
  want = sk.halo_merge_reference(want_buf, th_local, band_rows, above, below)
  sk.reset_launch_counts()
  got = sk.halo_merge(buf, th_local, band_rows, above, below)
  torch.cuda.synchronize()
  assert sk.launch_counts["halo_merge"] == (0 if peers == "none" else 1)
  assert torch.equal(got, want)
  assert torch.equal(buf, want_buf)
  assert got.data_ptr() == buf[band_rows:].data_ptr()
  with pytest.raises(ValueError):
    sk.halo_merge(buf, th_local, band_rows, torch.zeros(
        (band_rows - 1, slabw), device=cuda), None)


def test_band_sharded_path_on_card(cuda):
  """band_sharded_forward bit for bit stream_forward; band_sharded_grad's
  per-point gradients against the unsharded backward_reduce per column;
  every shard's K1, K2 and halo merge launched."""
  from tpu_splatting_torch.parallel.stream_sharded import (
      band_sharded_forward, band_sharded_grad)
  from tpu_splatting_torch.rasterizer.stream_function import backward_reduce
  config = RasterConfig(**BWD_MODES["heuristics"])
  m = mapping_for(cuda, config, size=(128, 128))
  mesh = make_mesh(4, devices=[cuda] * 4)
  full = sk.stream_forward(m, config)
  assert torch.equal(band_sharded_forward(m, config, mesh), full)
  gen = torch.Generator(device=cuda).manual_seed(5)
  gimg = torch.randn(full.shape, generator=gen, device=cuda)
  want = backward_reduce(m, full, gimg, config)
  sk.reset_launch_counts()
  img, got = band_sharded_grad(m, gimg, config, mesh)
  torch.cuda.synchronize()
  assert sk.launch_counts == {"stream_forward": 4, "stream_backward": 4,
                              "halo_merge": 4}
  assert torch.equal(img, full)
  assert float(want.abs().max()) > 0.1
  columns_close(got, want)


def test_band0_zero_is_the_unsharded_call(cuda):
  """band0 = 0 and halo off are the unsharded kernels: K1 bit for bit the
  default call, K2 within its gate (its atomics sum in a varying order)."""
  config = RasterConfig(**BWD_MODES["heuristics"])
  m = mapping_for(cuda, config)
  img = sk.stream_forward(m, config)
  assert torch.equal(sk.stream_forward(m, config, 0), img)
  gen = torch.Generator(device=cuda).manual_seed(6)
  gimg = torch.randn(img.shape, generator=gen, device=cuda)
  columns_close(sk.stream_backward(m, img, gimg, config, 0, halo=False),
                sk.stream_backward(m, img, gimg, config))


def test_dryrun_multichip_on_one_card(cuda, capsys):
  from tpu_splatting_torch.parallel.dryrun import dryrun_multichip
  dryrun_multichip(4, devices=[cuda] * 4)
  assert "OK" in capsys.readouterr().out


@pytest.fixture
def cards():
  """Every visible CUDA device, where there are at least two."""
  if torch.cuda.device_count() < 2:
    pytest.skip("needs two or more CUDA devices")
  return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def test_band_sharded_path_across_cards(cards):
  """One shard a card: the image bit for bit the one-card K1 image, the
  per-point gradients against the one-card backward_reduce per column."""
  from tpu_splatting_torch.parallel.stream_sharded import band_sharded_grad
  from tpu_splatting_torch.rasterizer.stream_function import backward_reduce
  config = RasterConfig(**BWD_MODES["heuristics"])
  m = mapping_for(cards[0], config, size=(128, 128))
  if m.tiles_high % len(cards):
    pytest.skip(f"{m.tiles_high} bands over {len(cards)} cards")
  full = sk.stream_forward(m, config)
  gen = torch.Generator(device=cards[0]).manual_seed(5)
  gimg = torch.randn(full.shape, generator=gen, device=cards[0])
  want = backward_reduce(m, full, gimg, config)
  img, got = band_sharded_grad(m, gimg, config, make_mesh())
  torch.cuda.synchronize()
  assert img.device == got.device == cards[0]
  assert torch.equal(img, full)
  columns_close(got, want)


def test_data_parallel_across_cards(cards, capsys):
  """One camera a card: loss and visibility against a one-card loop over
  the same cameras; then the dry run over every card."""
  from tpu_splatting_torch.parallel.data_parallel import data_parallel_loss
  from tpu_splatting_torch.parallel.dryrun import (_synthetic_scene,
                                                   dryrun_multichip)
  from tpu_splatting_torch.renderer import render_gaussians
  dev = cards[0]
  g, camera = _synthetic_scene(2000, (128, 96), seed=4, device=dev)
  config = RasterConfig(compute_visibility=True)
  b = len(cards)
  poses = camera.T_camera_world.repeat(b, 1, 1)
  poses[:, 0, 3] = 1e-2 * torch.arange(b, device=dev)
  projections = camera.projection.repeat(b, 1)
  targets = torch.rand((b, 96, 128, 3), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(1))
  probe = torch.zeros((2000, 1), device=dev, requires_grad=True)
  loss, fwd_vis = data_parallel_loss(make_mesh(), camera, config, None)(
      g, probe, projections, poses, targets)
  (gpr,) = torch.autograd.grad(loss, probe)
  probe1 = torch.zeros((2000, 1), device=dev, requires_grad=True)
  losses = [torch.mean((render_gaussians(
      g, camera.replace(T_camera_world=poses[i]), config,
      probe=probe1).image - targets[i]) ** 2) for i in range(b)]
  loss1 = torch.stack(losses).mean()
  (gpr1,) = torch.autograd.grad(loss1, probe1)
  assert float(gpr1.max()) > 0.1
  torch.testing.assert_close(loss.detach(), loss1.detach(), atol=0,
                             rtol=1e-5)
  torch.testing.assert_close(fwd_vis + gpr[:, 0], gpr1[:, 0], atol=1e-6,
                             rtol=1e-4)
  dryrun_multichip(b)
  assert "OK" in capsys.readouterr().out


# --- the data-movement probes of benchmarks/exp_mosaic.py -----------------

def finish_within(seconds):
  """Synchronise the card, failing after ``seconds``: a block whose
  mbarrier never sees its bytes spins (until the kernel's own 2 s
  watchdog traps)."""
  done = torch.cuda.Event()
  done.record()
  deadline = time.monotonic() + seconds
  while not done.query():
    if time.monotonic() > deadline:
      pytest.fail(f"the probe kernel did not finish within {seconds} s")
    time.sleep(0.001)
  torch.cuda.synchronize()


@pytest.mark.parametrize("key", ["T1", "T2", "T3", "T4"])
def test_mosaic_probes_on_their_inputs(cuda, key):
  """Each probe kernel, every instantiation, bit for bit its twin and the
  reference probe's own expect, on the probe's inputs; counted once a
  call as a probe."""
  from tpu_splatting_torch.benchmarks import exp_mosaic as em
  args, expect = em.probe_inputs(cuda)[key]
  _, fn, variants = em.PROBES[key]
  twin = getattr(em, fn.__name__ + "_reference")
  em.reset_launch_counts()
  for kw in variants:
    got = fn(*args, **kw)
    finish_within(30)
    assert torch.equal(got, twin(*args)), kw
    assert np.array_equal(got.cpu().numpy(), expect), kw
  assert em.probe_launch_counts[fn.__name__] == len(variants)
  assert sum(em.probe_launch_counts.values()) == len(variants)


def mosaic_case(dev, key, b=512, seed=0):
  """A probe's arguments at a mid size, b windows, from a seed."""
  rng = np.random.default_rng(seed)
  gen = torch.Generator(device=dev).manual_seed(seed)

  def table(*shape):
    return torch.randn(shape, generator=gen, device=dev)

  def ints(lo, hi):
    return torch.from_numpy(rng.integers(lo, hi, b).astype(np.int32)).to(dev)
  if key == "T1":
    return table(b, 256, 16), ints(-256, 256), 128
  if key == "T2":
    return table(b * 64, 128), 16
  if key == "T3":
    return table(b * 128, 16), ints(0, b * 128 - 128), 128
  return table(b * 64, 128), ints(0, b * 64 - 64 + 1), 64


@pytest.mark.parametrize("key, kw", [
    ("T1", {"staged": True}), ("T1", {"staged": False}),
    ("T2", {}),
    ("T3", {}), ("T4", {"bulk": True}), ("T4", {"bulk": False})])
def test_mosaic_kernels_match_twins(cuda, key, kw):
  """At 512 windows (T2: a (32768, 128) table), bit for bit against the
  twin."""
  from tpu_splatting_torch.benchmarks import exp_mosaic as em
  args = mosaic_case(cuda, key)
  _, fn, _ = em.PROBES[key]
  got = fn(*args, **kw)
  finish_within(30)
  want = getattr(em, fn.__name__ + "_reference")(*args)
  assert got.shape == want.shape
  assert torch.equal(got, want)


def test_mosaic_window_is_window_copy(cuda):
  """T3 with every count g is K6: bit for bit layout.window_copy."""
  from tpu_splatting_torch.benchmarks import exp_mosaic as em
  from tpu_splatting_torch.rasterizer import layout
  x, src, g = mosaic_case(cuda, "T3", seed=1)
  got = em.double_block_window(x, src, g)
  finish_within(30)
  cnt = torch.full_like(src, g)
  assert torch.equal(got.reshape(-1, x.shape[1]),
                     layout.window_copy(x, src, cnt, g))


def test_mosaic_kernels_reject_bad_inputs(cuda):
  """What the kernels cannot take raises before a launch."""
  from tpu_splatting_torch.benchmarks import exp_mosaic as em
  em.reset_launch_counts()
  d = torch.zeros(1, dtype=torch.int32, device=cuda)
  with pytest.raises(ValueError, match="multiple of 16 bytes"):
    em.dynamic_slice_rows(torch.zeros((1, 8, 6), device=cuda), d, 4)
  flat = torch.zeros(1 + 256 * 128, device=cuda)
  with pytest.raises(ValueError, match="x's address"):
    em.dma_residue_sum(flat[1:].view(256, 128), d)
  with pytest.raises(TypeError, match="int32"):
    em.double_block_window(torch.zeros((256, 16), device=cuda), d.long(), 128)
  with pytest.raises(ValueError, match="it takes 16"):
    em.reshape_rows(torch.zeros((4, 12), device=cuda), 12)
  with pytest.raises(ValueError, match="0 < rows <= R"):
    em.dma_residue_sum(torch.zeros((512, 128), device=cuda), d, rows=600)
  assert sum(em.probe_launch_counts.values()) == 0


def mosaic_edges(dev):
  """{case: (T2 table, T4 table, T4 starts)}: T2 tables of fewer rows than
  one chunk, a short last chunk and fewer chunks than blocks; T4 starts at
  0 and R - 64, repeated, all equal, one slab, and taller slabs."""
  gen = torch.Generator(device=dev).manual_seed(3)
  r = 4096

  def starts(*xs):
    return torch.tensor(xs, dtype=torch.int32, device=dev)
  rep = torch.arange(0, r - 64, 97, dtype=torch.int32, device=dev)
  return {
      "ends": (8, starts(0, r - 64, 0, r - 64, 17, r - 65), 64),
      "repeated": (100, rep.repeat_interleave(9), 64),
      "all_equal": (300, torch.full((300,), 1234, dtype=torch.int32,
                                    device=dev), 64),
      "one_slab": (1, starts(r - 64), 64),
      "tall": (257 * 8, starts(0, 5, 3000, 3001, r - 500), 500),
  }, torch.rand((r, 128), generator=gen, device=dev)


@pytest.mark.parametrize("case", ["ends", "repeated", "all_equal",
                                  "one_slab", "tall"])
def test_mosaic_edge_inputs(cuda, case):
  """T2 and both T4 instantiations bit for bit their twins on edge
  inputs."""
  from tpu_splatting_torch.benchmarks import exp_mosaic as em
  cases, x4 = mosaic_edges(cuda)
  t2_rows, s, rows = cases[case]
  x2 = x4[:t2_rows // 8 + 1]           # (R, 128): t2_rows // 8 * 8 + 8 rows
  got = em.reshape_rows(x2, 16)
  finish_within(30)
  assert torch.equal(got, em.reshape_rows_reference(x2, 16))
  want = em.dma_residue_sum_reference(x4, s, rows)
  for bulk in (True, False):
    got = em.dma_residue_sum(x4, s, rows, bulk=bulk)
    finish_within(30)
    assert torch.equal(got, want), bulk


# --- the packed-table probes of benchmarks/exp_pack.py --------------------

@pytest.mark.parametrize("key", ["U1", "U1b", "U2"])
def test_pack_probes_on_their_inputs(cuda, key):
  """unpack_rows bit for bit its twin and the probe's own expect (x.T) on
  the probe's inputs; counted once a call as a probe."""
  from tpu_splatting_torch.benchmarks import exp_pack as ep
  _, (xp, w, order), expect = ep.unpack_inputs(cuda)[key]
  ep.reset_launch_counts()
  got = ep.unpack_rows(xp, w, order)
  torch.cuda.synchronize()
  assert torch.equal(got, ep.unpack_rows_reference(xp, w, order))
  assert np.array_equal(got.cpu().numpy(), expect)
  assert ep.probe_launch_counts == {"unpack_rows": 1, "slab_relayout": 0,
                                    "column_sums": 0}


@pytest.mark.parametrize("w, order", [(16, "row"), (11, "row"), (12, "col"),
                                      (12, "row"), (16, "col"), (11, "col"),
                                      (7, "row"), (32, "col")])
@pytest.mark.parametrize("p", [64, 37])
def test_unpack_rows_kernel_matches_twin(cuda, w, order, p):
  """Every order at the probes' widths and others, 300 blocks, bit for
  bit the twin."""
  from tpu_splatting_torch.benchmarks import exp_pack as ep
  gen = torch.Generator(device=cuda).manual_seed(w * p)
  xp = torch.randn((300, p, 8 * w), generator=gen, device=cuda)
  got = ep.unpack_rows(xp, w, order)
  torch.cuda.synchronize()
  assert torch.equal(got, ep.unpack_rows_reference(xp, w, order))


@pytest.mark.parametrize("c, packed", [(12, False), (32, False), (13, False),
                                       (128, True)])
@pytest.mark.parametrize("slabs", [1, 3, 1000])
def test_slab_relayout_kernel_matches_twin(cuda, c, packed, slabs):
  from tpu_splatting_torch.benchmarks import exp_pack as ep
  rows = 64 if packed else 512
  gen = torch.Generator(device=cuda).manual_seed(c + slabs)
  x = torch.randn((slabs * rows, c), generator=gen, device=cuda)
  got = ep.slab_relayout(x, packed)
  torch.cuda.synchronize()
  assert torch.equal(got, ep.slab_relayout_reference(x, packed))


@pytest.mark.parametrize("packed", [False, True])
def test_slab_relayout_is_the_last_slab(cuda, packed):
  """Every slab but the last holds NaN: the result is the last slab's
  block, whatever order the blocks ran in."""
  from tpu_splatting_torch.benchmarks import exp_pack as ep
  rows, c = (64, 128) if packed else (512, 12)
  x = torch.full((500 * rows, c), float("nan"), device=cuda)
  x[-rows:] = torch.arange(rows * c, dtype=torch.float32,
                           device=cuda).reshape(rows, c)
  got = ep.slab_relayout(x, packed)
  torch.cuda.synchronize()
  assert torch.isfinite(got).all()
  assert torch.equal(got, ep.slab_relayout_reference(x[-rows:], packed))


COLUMN_CASES = [(12, 1024), (11, 1024), (32, 1024), (128, 128), (300, 64),
                (12, 1000)]


@pytest.mark.parametrize("w, rows", COLUMN_CASES)
def test_column_sums_kernel_matches_twin(cuda, w, rows):
  """Within 1e-5 of each column's sum of |x| of the twin; the tail rows
  (NaN here) are not read."""
  from tpu_splatting_torch.benchmarks import exp_pack as ep
  gen = torch.Generator(device=cuda).manual_seed(w + rows)
  g = 37
  x = torch.randn((g * rows + rows // 2, w), generator=gen, device=cuda)
  x[g * rows:] = float("nan")
  got = ep.column_sums(x, rows)
  torch.cuda.synchronize()
  want = ep.column_sums_reference(x[:g * rows], rows)
  scale = x[:g * rows].abs().sum(0, keepdim=True)
  assert got.shape == (1, w) and torch.isfinite(got).all()
  assert bool(((got - want).abs() <= 1e-5 * scale).all())


@pytest.mark.parametrize("w, rows", COLUMN_CASES[:5])
def test_column_sums_kernel_is_deterministic(cuda, w, rows):
  """Two runs on the same table agree bit for bit (no atomics)."""
  from tpu_splatting_torch.benchmarks import exp_pack as ep
  gen = torch.Generator(device=cuda).manual_seed(7 * w)
  x = torch.randn((1953 * rows // 8, w), generator=gen, device=cuda)
  a = ep.column_sums(x, rows // 8)
  b = ep.column_sums(x, rows // 8)
  torch.cuda.synchronize()
  assert torch.equal(a, b)


def test_pack_kernels_reject_bad_inputs(cuda):
  """What the kernels cannot take raises before a launch."""
  from tpu_splatting_torch.benchmarks import exp_pack as ep
  ep.reset_launch_counts()
  flat = torch.zeros(1 + 4 * 64 * 128, device=cuda)
  with pytest.raises(ValueError, match="x's address"):
    ep.unpack_rows(flat[1:].view(4, 64, 128), 16)
  with pytest.raises(ValueError, match="x's address"):
    ep.slab_relayout(flat[1:].view(256, 128), packed=True)
  with pytest.raises(ValueError, match="232448 B"):
    ep.unpack_rows(torch.zeros((1, 1024, 128), device=cuda), 16)
  with pytest.raises(ValueError, match="232448 B"):
    ep.slab_relayout(torch.zeros((512, 200), device=cuda))
  with pytest.raises(TypeError, match="float64"):
    ep.column_sums(torch.zeros((8, 12), dtype=torch.float64, device=cuda), 4)
  with pytest.raises(ValueError, match=r"\(B, P, 8 w\)"):
    ep.unpack_rows(torch.zeros((1, 4, 90), device=cuda), 11)
  with pytest.raises(ValueError, match=r"\(S 64, 128\)"):
    ep.slab_relayout(torch.zeros((64, 96), device=cuda), packed=True)
  with pytest.raises(ValueError, match="block_rows > 0"):
    ep.column_sums(torch.zeros((8, 12), device=cuda), 0)
  assert sum(ep.probe_launch_counts.values()) == 0


# --- the packed-table probes of benchmarks/exp_pack2.py -------------------

def test_pack2_probes_on_their_inputs(cuda):
  """Each kernel bit for bit its twin and the probe's own expect on the
  probe's inputs; counted once a call as a probe."""
  from tpu_splatting_torch.benchmarks import exp_pack2 as ep2
  rows = ep2.probe_rows()
  xp = torch.as_tensor(rows.reshape(1, 64, 128), device=cuda)
  x = torch.as_tensor(ep2.probe_repeat_input()[None], device=cuda)
  g = torch.as_tensor(ep2.probe_gradient()[None], device=cuda)
  perm = torch.as_tensor(ep2.perm_cprime(), dtype=torch.int32)
  inv = np.empty(512, np.int64)
  inv[ep2.perm_cprime()] = np.arange(512)
  ep2.reset_launch_counts()
  cases = [
      (ep2.permuted_unpack(xp, 16), ep2.permuted_unpack_reference(xp, 16),
       rows.T[:, ep2.perm_cprime()][None]),
      (ep2.repeat_rows(x, 2), ep2.repeat_rows_reference(x, 2),
       np.tile(x[0].cpu().numpy(), (2, 1))[None]),
      (ep2.repeat_rows(x, 2, "element"),
       ep2.repeat_rows_reference(x, 2, "element"),
       np.repeat(x[0].cpu().numpy(), 2, axis=0)[None]),
      (ep2.unpack_direct(xp, 16), ep2.unpack_direct_reference(xp, 16),
       rows.T[None]),
      (ep2.permute_lanes(g, perm), ep2.permute_lanes_reference(g, perm),
       g[0].cpu().numpy()[:, inv][None])]
  torch.cuda.synchronize()
  for i, (got, twin, expect) in enumerate(cases):
    assert torch.equal(got, twin), i
    assert np.array_equal(got.cpu().numpy(), expect), i
  assert ep2.probe_launch_counts == {
      "permuted_unpack": 1, "slab_relayout_permuted": 0, "repeat_rows": 2,
      "unpack_direct": 1, "permute_lanes": 1}


@pytest.mark.parametrize("w, p", [(16, 64), (11, 64), (12, 64), (16, 37),
                                  (7, 5), (32, 64)])
def test_pack2_unpacks_match_twins(cuda, w, p):
  """permuted_unpack and unpack_direct at the probe's widths and others,
  300 blocks, bit for bit their twins; unpack_direct bit for bit
  exp_pack.unpack_rows in row order."""
  from tpu_splatting_torch.benchmarks import exp_pack as ep
  from tpu_splatting_torch.benchmarks import exp_pack2 as ep2
  gen = torch.Generator(device=cuda).manual_seed(w * p)
  xp = torch.randn((300, p, 8 * w), generator=gen, device=cuda)
  perm = ep2.permuted_unpack(xp, w)
  direct = ep2.unpack_direct(xp, w)
  torch.cuda.synchronize()
  assert torch.equal(perm, ep2.permuted_unpack_reference(xp, w))
  assert torch.equal(direct, ep2.unpack_direct_reference(xp, w))
  assert torch.equal(direct, ep.unpack_rows(xp, w, "row"))


@pytest.mark.parametrize("slabs", [1, 3, 1000])
def test_slab_relayout_permuted_matches_twin(cuda, slabs):
  from tpu_splatting_torch.benchmarks import exp_pack2 as ep2
  gen = torch.Generator(device=cuda).manual_seed(slabs)
  x = torch.randn((slabs * 64, 128), generator=gen, device=cuda)
  got = ep2.slab_relayout_permuted(x)
  torch.cuda.synchronize()
  assert torch.equal(got, ep2.slab_relayout_permuted_reference(x))


def test_slab_relayout_permuted_is_the_last_slab(cuda):
  """Every slab but the last holds NaN: the result is the last slab's
  block, whatever order the blocks ran in."""
  from tpu_splatting_torch.benchmarks import exp_pack2 as ep2
  x = torch.full((500 * 64, 128), float("nan"), device=cuda)
  x[-64:] = torch.arange(64 * 128, dtype=torch.float32,
                         device=cuda).reshape(64, 128)
  got = ep2.slab_relayout_permuted(x)
  torch.cuda.synchronize()
  assert torch.isfinite(got).all()
  assert torch.equal(got, ep2.slab_relayout_permuted_reference(x[-64:]))


@pytest.mark.parametrize("mode", ["tile", "element"])
@pytest.mark.parametrize("shape, n", [((300, 64, 128), 2), ((7, 5, 12), 3),
                                      ((2, 1, 4), 8)])
def test_repeat_rows_kernel_matches_twin(cuda, mode, shape, n):
  from tpu_splatting_torch.benchmarks import exp_pack2 as ep2
  gen = torch.Generator(device=cuda).manual_seed(n)
  x = torch.randn(shape, generator=gen, device=cuda)
  got = ep2.repeat_rows(x, n, mode)
  torch.cuda.synchronize()
  assert torch.equal(got, ep2.repeat_rows_reference(x, n, mode))


@pytest.mark.parametrize("shape", [(300, 16, 512), (3, 5, 64), (1, 17, 36)])
def test_permute_lanes_kernel_matches_twin(cuda, shape):
  """A random permutation (and the probe's at L 512), bit for bit the
  twin and the definition."""
  from tpu_splatting_torch.benchmarks import exp_pack2 as ep2
  gen = torch.Generator(device=cuda).manual_seed(shape[2])
  x = torch.randn(shape, generator=gen, device=cuda)
  perms = [torch.as_tensor(np.random.default_rng(shape[0]).permutation(
      shape[2]))]
  if shape[2] == 512:
    perms.append(torch.as_tensor(ep2.perm_cprime(), device=cuda))
  for perm in perms:
    got = ep2.permute_lanes(x, perm)
    torch.cuda.synchronize()
    assert torch.equal(got, ep2.permute_lanes_reference(x, perm))
    want = torch.empty_like(x)
    want[..., perm.to(cuda).long()] = x
    assert torch.equal(got, want)


def test_pack2_kernels_reject_bad_inputs(cuda):
  """What the kernels cannot take raises before a launch."""
  from tpu_splatting_torch.benchmarks import exp_pack2 as ep2
  ep2.reset_launch_counts()
  flat = torch.zeros(1 + 4 * 64 * 128, device=cuda)
  with pytest.raises(ValueError, match="x's address"):
    ep2.permuted_unpack(flat[1:].view(4, 64, 128), 16)
  with pytest.raises(ValueError, match="x's address"):
    ep2.slab_relayout_permuted(flat[1:].view(256, 128))
  with pytest.raises(ValueError, match="x's address"):
    ep2.unpack_direct(flat[1:].view(4, 64, 128), 16)
  with pytest.raises(ValueError, match="a row is"):
    ep2.repeat_rows(torch.zeros((1, 8, 6), device=cuda), 2)
  with pytest.raises(ValueError, match="a row is"):
    ep2.permute_lanes(torch.zeros((1, 8, 6), device=cuda), torch.arange(6))
  with pytest.raises(ValueError, match="232448 B"):
    ep2.permuted_unpack(torch.zeros((1, 1024, 128), device=cuda), 16)
  with pytest.raises(ValueError, match="not a permutation"):
    ep2.permute_lanes(torch.zeros((1, 2, 4), device=cuda),
                      torch.tensor([0, 1, 1, 3]))
  with pytest.raises(TypeError, match="float64"):
    ep2.repeat_rows(torch.zeros((1, 8, 4), dtype=torch.float64, device=cuda),
                    2)
  assert sum(ep2.probe_launch_counts.values()) == 0


def test_pack2_smem_formulas_match_the_kernels(cuda):
  """The wrapper's shared-memory formulas equal the C entry's."""
  from tpu_splatting_torch.benchmarks import exp_pack2 as ep2
  lib = ep2._kernel()
  for p in (1, 5, 37, 64, 100):
    for w in (7, 11, 12, 16, 32):
      assert lib.tpu_splat_pack2_smem(0, p, w) == ep2.permuted_smem(p, w)
  for l in (4, 36, 64, 512, 1000):
    assert lib.tpu_splat_pack2_smem(1, l, 0) == ep2.lane_smem(l)


def test_ply_load_on_card_equals_cpu(cuda, tmp_path):
  """A checkpoint loaded onto the card (the default device) equals the
  CPU load bit for bit, and saving from the card writes the same bytes."""
  from tpu_splatting_torch.examples.render_ply import synthetic_checkpoint
  from tpu_splatting_torch.io import ply
  path = str(tmp_path / "s.ply")
  synthetic_checkpoint(path, 5000)
  on_card = ply.load_gaussians(path)
  on_cpu = ply.load_gaussians(path, device="cpu")
  for f in dataclasses.fields(on_cpu):
    a = getattr(on_card, f.name)
    assert a.is_cuda, f.name
    assert torch.equal(a.cpu(), getattr(on_cpu, f.name)), f.name
  ply.save_gaussians(str(tmp_path / "card.ply"), on_card)
  assert (tmp_path / "card.ply").read_bytes() == open(path, "rb").read()


def test_argsort_morton_on_card_equals_cpu(cuda):
  """The Morton codes and the permutation on the card equal the CPU's
  exactly, duplicate points (ties) included."""
  from tpu_splatting_torch.misc.morton import argsort_morton, morton_codes_60
  rng = np.random.default_rng(0)
  base = rng.normal(0.0, 1.2, (20_000, 3)).astype(np.float32)
  p = torch.from_numpy(base[rng.integers(0, 20_000, 200_000)])
  for a, b in zip(morton_codes_60(p.to(cuda)), morton_codes_60(p)):
    assert torch.equal(a.cpu(), b)
  assert torch.equal(argsort_morton(p.to(cuda)).cpu(), argsort_morton(p))


def test_render_ply_example_on_card(cuda, tmp_path):
  """``render_ply`` on the card (its default device) at the JAX test's
  setting: one K1 launch, and the image and weight equal the CPU run's
  (the plain twins) to 1e-4, the overflow count exactly."""
  from tpu_splatting_torch.examples import render_ply
  argv = [str(tmp_path / "s.ply"), "--synthetic", "500", "--image_size",
          "64,48", "--out", str(tmp_path / "r.npy")]
  sk.reset_launch_counts()
  wm = render_ply.main(argv)
  assert sk.launch_counts["stream_forward"] == 1
  assert wm > 0
  img = np.load(tmp_path / "r.npy")
  assert img.shape == (48, 64, 3) and np.isfinite(img).all()
  got = render_ply.render(render_ply.parse_args(argv))
  want = render_ply.render(render_ply.parse_args([*argv, "--device", "cpu"]))
  for name in ("image", "image_weight"):
    torch.testing.assert_close(getattr(got, name).cpu(), getattr(want, name),
                               atol=1e-4, rtol=0)
  assert int(got.num_overflow) == int(want.num_overflow)


def test_2d_examples_on_card(cuda, tmp_path):
  """``vis_split`` and ``test_backward`` at their defaults on the card:
  both images written, K1 and K2 launched.  Against the same examples
  with ``--device cpu`` (the plain twins): the images to 1e-4, the loss
  to 1e-5 relative, each gradient to 1e-4 of its largest magnitude."""
  from tpu_splatting_torch.examples import test_backward, vis_split
  sk.reset_launch_counts()
  card = tmp_path / "card"
  before, after = vis_split.main(["--out", str(card)])
  loss, grads = test_backward.main([])
  assert sk.launch_counts["stream_forward"] == 3
  assert sk.launch_counts["stream_backward"] == 1
  assert before.is_cuda
  assert sorted(p.stem for p in card.iterdir()) == ["after_split",
                                                    "before_split"]
  cpu_images = vis_split.main(["--out", str(tmp_path / "cpu"), "--device",
                               "cpu"])
  for got, want in zip((before, after), cpu_images):
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)
  loss_cpu, grads_cpu = test_backward.main(["--device", "cpu"])
  assert loss > 0 and abs(loss - loss_cpu) <= 1e-5 * abs(loss_cpu)
  for name, want in grads_cpu.items():
    got = grads[name]
    assert got.is_cuda and torch.isfinite(got).all(), name
    scale = float(want.abs().max())
    torch.testing.assert_close(got.cpu(), want, atol=1e-4 * scale, rtol=0,
                               msg=name)


def test_heavy_map_scripts_and_stage_split_on_card(cuda, tmp_path,
                                                   monkeypatch, capsys):
  """``profile_map`` and ``profile_map2`` on the bench's heavy scene at
  200k splats, 2048x1536: each exits 0 with a line per variant and per
  stage; then the stage split of one ``stream_map`` call sums to within
  10% of the call's device time (``diagnostics.device_reading``), and
  every stage launched kernels."""
  import argparse
  from tpu_splatting_torch import bench
  from tpu_splatting_torch.benchmarks import diagnostics as dg
  from tpu_splatting_torch.benchmarks import profile_map, profile_map2
  monkeypatch.setattr(bench, "CAL_PATH", str(tmp_path / "cal.json"))
  argv = ["--scene", "heavy", "--n", "200000", "--iters", "1"]
  assert profile_map.main(argv) == 0
  assert profile_map2.main(argv) == 0
  out = capsys.readouterr().out
  for label, _, _ in profile_map.VARIANTS:
    assert f"\n{label}: " in out, label
  for stage in profile_map2.STAGES:
    assert f"\nstage {stage}: device " in out, stage
  args = argparse.Namespace(n=200_000, size=bench.IMAGE_SIZE, gw=8)
  s = dg.prepare("heavy", args, cuda)
  call = lambda: profile_map.map_call(s, bench.IMAGE_SIZE, s.caps)(
      *s.map_args)
  call()
  torch.cuda.synchronize()
  reading = dg.device_reading(call)
  assert reading is not None, "the profiler lost kernel records"
  whole = reading[0]
  for _ in range(3):          # a profiler session may lose kernel records
    split = profile_map2.stage_split(call, cuda)
    total = sum(st.ms for st in split.values())
    if abs(total - whole) <= 0.1 * whole:
      break
  assert abs(total - whole) <= 0.1 * whole, (total, whole)
  assert list(split) == list(profile_map2.STAGES)
  assert all(st.kernels > 0 for st in split.values()), split
