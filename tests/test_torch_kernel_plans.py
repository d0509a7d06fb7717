"""The compositing kernels' launch plans, in plain Python (no card).

Each CUDA wrapper picks an instantiation (the register instantiation whose
most features hold F, for tiles of whole warps up to 256 pixels, else the
generic one: 0), a block of threads (one per pixel, rounded up to whole
warps for K2, K4 and K5) and the bytes of shared memory one block needs;
it raises ValueError only where those bytes exceed one block's 232,448.
The expected bytes restate each kernel's shared-memory layout:

* K1 (stream forward): rank keys (slab_cap rounded up to a power of two),
  7 + F coefficients a slab row, 7 ints a window, 2 counters, and, generic,
  F accumulators a thread.
* K2 (stream backward): rank keys, 12 + F coefficients a slab row, the
  gradient columns at a stride of slab_cap rounded up to 32 plus one, 8
  ints a window, 2 counters, and, generic, F image cotangents a thread.
* K4 (sorted forward): 7 + F coefficients a chunk row, one visibility
  partial a warp and row, and, generic, F accumulators a thread.
* K5 (sorted backward): 13 + F coefficients a chunk row, the gradient
  columns at a stride of chunk rounded up to 32 plus one, and, generic, F
  image cotangents a thread.

On the card ``chip_smoke.py`` holds these plans against the kernels' own
``*_smem`` entries.
"""

import numpy as np
import pytest
import torch

from tpu_splatting_torch import RasterConfig, calibrate_stream, stream_map
from tpu_splatting_torch.rasterizer import kernels as kk
from tpu_splatting_torch.rasterizer import stream_kernels as sk
from tpu_splatting_torch.scenes import uniform_scene
from tpu_splatting_torch.utils import cuda_build as cb


def headline_plans(f, tile_area):
  """K1 at slab_cap 512, w_max 27; K2 at slab_cap 128, w_max 27 with
  heuristics (7 + F + 3 columns); K4 and K5 at chunk 128 (K5 with
  heuristics: 7 + F + 2 columns)."""
  return {"K1": tuple(sk.stream_forward_plan(f, 512, 27, tile_area)),
          "K2": tuple(sk.stream_backward_plan(f, 128, 27, 10 + f,
                                              tile_area)),
          "K4": tuple(kk.sorted_forward_plan(f, 128, tile_area)),
          "K5": tuple(kk.sorted_backward_plan(f, 128, 9 + f, tile_area))}


# (features, pixels a tile) -> {kernel: (instantiation, threads, bytes)}
EXPECTED = {
    (3, 256): {"K1": (8, 256, 23292), "K2": (6, 256, 15772),
               "K4": (8, 256, 9216), "K5": (7, 256, 14384)},
    (56, 256): {"K1": (56, 256, 131836), "K2": (56, 256, 70256),
                "K4": (56, 256, 36352), "K5": (56, 256, 68868)},
    (57, 256): {"K1": (0, 256, 192252), "K2": (0, 256, 129652),
                "K4": (0, 256, 95232), "K5": (0, 256, 128264)},
    (64, 256): {"K1": (0, 256, 213756), "K2": (0, 256, 144016),
                "K4": (0, 256, 105984), "K5": (0, 256, 142628)},
    (100, 256): {"K1": (0, 256, 324348), "K2": (0, 256, 217888),
                 "K4": (0, 256, 161280), "K5": (0, 256, 216500)},
    (3, 16): {"K1": (0, 16, 23484), "K2": (0, 32, 16156),
              "K4": (0, 32, 6016), "K5": (0, 32, 14768)},
    (56, 16): {"K1": (0, 16, 135420), "K2": (0, 32, 77424),
               "K4": (0, 32, 39936), "K5": (0, 32, 76036)},
    (57, 16): {"K1": (0, 16, 137532), "K2": (0, 32, 78580),
               "K4": (0, 32, 40576), "K5": (0, 32, 77192)},
    (64, 16): {"K1": (0, 16, 152316), "K2": (0, 32, 86672),
               "K4": (0, 32, 45056), "K5": (0, 32, 85284)},
    (100, 16): {"K1": (0, 16, 228348), "K2": (0, 32, 128288),
                "K4": (0, 32, 68096), "K5": (0, 32, 126900)},
}


@pytest.mark.parametrize("f,tile_area", sorted(EXPECTED),
                         ids=[f"F{f}-pix{p}" for f, p in sorted(EXPECTED)])
def test_plans_at_headline_capacities(f, tile_area):
  assert headline_plans(f, tile_area) == EXPECTED[(f, tile_area)]


def test_shared_memory_layouts_restated():
  """The bytes of one generic and one register plan, term by term."""
  f, g, pix = 64, 128, 256
  stride = 129                      # 128 rounded up to 32, plus one
  assert kk.sorted_backward_plan(f, g, 73, pix).smem == 4 * (
      g * (13 + f) + 73 * stride + f * pix)
  assert kk.sorted_forward_plan(f, g, pix).smem == 4 * (
      g * (7 + f + pix // 32) + f * pix)
  assert sk.stream_forward_plan(3, 300, 20, pix).smem == 4 * (
      512 + 10 * 300 + 7 * 20 + 2)
  assert sk.stream_backward_plan(3, 300, 20, 13, pix).smem == 4 * (
      512 + 15 * 300 + 13 * (320 + 1) + 8 * 20 + 2)


@pytest.mark.parametrize("f", [3, 56, 100])
def test_tiles_above_256_pixels_take_the_generic_instantiation(f):
  plans = headline_plans(f, 1024)
  assert all(p[0] == 0 and p[1] == 1024 for p in plans.values()), plans


@pytest.mark.parametrize("widths,picks", [
    (sk.K1_WIDTHS, {1: 8, 8: 8, 9: 24, 24: 24, 25: 56, 56: 56, 57: 0}),
    (sk.K2_WIDTHS, {1: 6, 6: 6, 7: 22, 22: 22, 23: 56, 56: 56, 57: 0}),
    (kk.K4_WIDTHS, {1: 8, 8: 8, 9: 24, 24: 24, 25: 56, 56: 56, 57: 0}),
    (kk.K5_WIDTHS, {1: 7, 7: 7, 8: 23, 23: 23, 24: 56, 56: 56, 57: 0})])
def test_instantiation_by_features(widths, picks):
  """The headline's F = 3 keeps its register instantiation; past 56
  features every kernel takes the generic one."""
  for f, want in picks.items():
    assert cb.instantiation(f, 256, widths) == want, f
    assert cb.instantiation(f, 64, widths) == want, f


@pytest.mark.parametrize("tile_area", [16, 36, 100, 400, 1024])
def test_tiles_of_partial_warps_or_many_pixels_are_generic(tile_area):
  assert cb.instantiation(3, tile_area, sk.K2_WIDTHS) == 0
  assert cb.block_threads(tile_area) % 32 == 0
  assert 0 <= cb.block_threads(tile_area) - tile_area < 32


def test_check_smem_raises_with_the_bytes():
  fits = cb.KernelPlan(0, 256, cb.SMEM_LIMIT)
  cb.check_smem("K", fits, "shapes")
  with pytest.raises(ValueError, match=r"needs 232449 B of shared memory "
                     r"a block \(shapes\); one block holds at most 232448 B"):
    cb.check_smem("K", fits._replace(smem=cb.SMEM_LIMIT + 1), "shapes")


def test_cpu_tensors_take_the_twins_at_any_shape():
  """On the CPU no plan is consulted: 100 features at tile_size 4 render
  through the twins of both pipelines, and no kernel launches."""
  from tpu_splatting_torch import map_to_tiles
  n, size = 300, (32, 32)
  packed, depth, _ = (torch.from_numpy(x) for x in uniform_scene(
      np.random.default_rng(0), n, size))
  feats = torch.from_numpy(np.random.default_rng(1).uniform(
      0.0, 1.0, (n, 100)).astype(np.float32))
  config = RasterConfig(tile_size=4)
  cal = calibrate_stream(packed, depth, feats, size, config, group_width=8)
  m = stream_map(packed, depth, feats, size, config, group_width=8,
                 **{k: cal[k] for k in ("num_slabs", "strip_cap", "slab_cap",
                                        "w_max", "run_cap", "wide_cap",
                                        "dup_cap")})
  sk.reset_launch_counts()
  kk.reset_launch_counts()
  img = sk.stream_forward(m, config)
  assert img.shape == (m.num_tiles, 101, 16) and float(img.max()) > 0.1
  tm = map_to_tiles(packed, depth, size, config, max_overlaps=20000,
                    features=feats)
  img_s, _ = kk.forward(tm.sorted_payload, tm.chunk_src, tm.chunk_cnt,
                        tm.chunk_to_tile, config, tm.num_tiles, tm.tiles_wide)
  assert img_s.shape == (tm.num_tiles + 1, 101, 16)
  assert sk.launch_counts == {"stream_forward": 0, "stream_backward": 0}
  assert kk.launch_counts == {"sorted_forward": 0, "sorted_backward": 0}
