"""The compositing kernels' launch plans, in plain Python (no card).

Each CUDA wrapper picks an instantiation (the register instantiation whose
most features hold F, for tiles of whole warps up to 256 pixels, else the
generic one: 0), a block of threads (one per pixel, rounded up to whole
warps) and the bytes of shared memory one block needs; it raises
ValueError only where those bytes exceed one block's 232,448.  The
expected bytes restate each kernel's shared-memory layout:

* K1 (stream forward): rank keys (slab_cap rounded up to a power of two),
  4 footprint floats and 7 + F coefficients a slab row, 7 ints a window,
  2 counters, generic F accumulators a thread, and a 16-bit row list of
  slab_cap entries a warp.
* K2 (stream backward): the slab's rank keys, and per row of a chunk of
  the slab 12 + F coefficients and the gradient columns at a stride of the
  chunk rounded up to 32 plus one, 8 ints a window, 2 counters, and,
  generic, F image cotangents a thread.  The chunk is the whole slab
  where that holds three blocks an SM (every row of ``EXPECTED``).
* K4 (sorted forward): 4 footprint floats and 7 + F coefficients a chunk
  row, one visibility partial a warp and row, generic F accumulators a
  thread, and a 16-bit row list of chunk entries a warp.
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
    (3, 256): {"K1": (4, 256, 39676), "K2": (6, 256, 15772),
               "K4": (4, 256, 13312), "K5": (7, 256, 14384)},
    (56, 256): {"K1": (56, 256, 148220), "K2": (56, 256, 70256),
                "K4": (56, 256, 40448), "K5": (56, 256, 68868)},
    (57, 256): {"K1": (0, 256, 208636), "K2": (0, 256, 129652),
                "K4": (0, 256, 99328), "K5": (0, 256, 128264)},
    (64, 256): {"K1": (0, 256, 230140), "K2": (0, 256, 144016),
                "K4": (0, 256, 110080), "K5": (0, 256, 142628)},
    (100, 256): {"K1": (0, 256, 340732), "K2": (0, 256, 217888),
                 "K4": (0, 256, 165376), "K5": (0, 256, 216500)},
    (3, 16): {"K1": (0, 32, 32892), "K2": (0, 32, 16156),
              "K4": (0, 32, 8320), "K5": (0, 32, 14768)},
    (56, 16): {"K1": (0, 32, 148220), "K2": (0, 32, 77424),
               "K4": (0, 32, 42240), "K5": (0, 32, 76036)},
    (57, 16): {"K1": (0, 32, 150396), "K2": (0, 32, 78580),
               "K4": (0, 32, 42880), "K5": (0, 32, 77192)},
    (64, 16): {"K1": (0, 32, 165628), "K2": (0, 32, 86672),
               "K4": (0, 32, 47360), "K5": (0, 32, 85284)},
    (100, 16): {"K1": (0, 32, 243964), "K2": (0, 32, 128288),
                "K4": (0, 32, 70400), "K5": (0, 32, 126900)},
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
      g * (4 + 7 + f + pix // 32) + f * pix) + 2 * (pix // 32) * g
  assert sk.stream_forward_plan(3, 300, 20, pix).smem == 4 * (
      512 + 14 * 300 + 7 * 20 + 2) + 2 * (pix // 32) * 300
  assert sk.stream_backward_plan(3, 300, 20, 13, pix).smem == 4 * (
      512 + 15 * 300 + 13 * (320 + 1) + 8 * 20 + 2)


# (features, pixels a tile) of K2's chunk cases: the register
# instantiations <6, 16>, <22, 32>, <56, 32> and two generic shapes
K2_SHAPES = [(3, 256), (6, 256), (22, 256), (56, 256), (3, 16), (64, 256)]
K2_CAPS = [512, 1024, 1536, 1792, 2048]
THIRD = cb.SMEM_SM // 3 - cb.SMEM_RESERVED       # 76,800 B: three blocks


def k2_blocks(f, slab_cap, chunk, tile_area, w_max=58):
  threads = cb.block_threads(tile_area)
  generic = cb.instantiation(f, tile_area, sk.K2_WIDTHS) == 0
  slabw = 10 + f
  smem = 4 * (sk._sort_cap(slab_cap) + (12 + f) * chunk
              + slabw * cb.acc_stride(chunk) + 8 * w_max + 2
              + (f * threads if generic else 0))
  return smem, min(3, cb.blocks_by_smem(smem))


@pytest.mark.parametrize("slab_cap", K2_CAPS)
@pytest.mark.parametrize("f,tile_area", K2_SHAPES,
                         ids=[f"F{f}-pix{p}" for f, p in K2_SHAPES])
def test_backward_plan_stages_the_largest_chunk_of_three_blocks(
    f, tile_area, slab_cap):
  """K2 at the heavy scene's slab capacities (w_max 58, heuristics: 10 + F
  columns): the chunk is the whole slab or a multiple of 32 from 128 below
  it; of those it holds the most blocks an SM (up to three) and is the
  largest that does; the bytes restate the layout at that chunk, fit one
  block, and at F <= 6 a third of the SM.  Once the slab is chunked its
  bytes stop growing with slab_cap but for the rank keys, as long as it
  keeps its blocks (<56, 32>'s 128-row chunks hold three blocks at 512
  and 1024; past them the keys leave room for two)."""
  slabw = 10 + f
  plan = sk.stream_backward_plan(f, slab_cap, 58, slabw, tile_area)
  chunk = sk.stream_backward_chunk(f, slab_cap, 58, slabw, tile_area)
  assert chunk == slab_cap or (chunk % 32 == 0 and 128 <= chunk < slab_cap)
  smem, blocks = k2_blocks(f, slab_cap, chunk, tile_area)
  assert plan.smem == smem <= cb.SMEM_LIMIT
  candidates = [slab_cap, *range(128, slab_cap, 32)]
  best = max(k2_blocks(f, slab_cap, c, tile_area)[1] for c in candidates)
  assert blocks == best >= 1
  assert all(k2_blocks(f, slab_cap, c, tile_area)[1] < best
             for c in candidates if c > chunk)
  if f <= 6 and tile_area == 256:
    assert (blocks, plan.smem <= THIRD) == (3, True), plan
  keys = 4 * sk._sort_cap(slab_cap)
  for cap in K2_CAPS:
    if chunk < slab_cap < cap:
      later = sk.stream_backward_plan(f, cap, 58, slabw, tile_area)
      if min(3, cb.blocks_by_smem(later.smem)) == blocks:
        assert later.smem - 4 * sk._sort_cap(cap) <= plan.smem - keys


@pytest.mark.parametrize("slab_cap,chunk,smem", [
    (512, 512, 61308), (1024, 608, 74108), (1536, 576, 74620),
    (1792, 576, 74620), (2048, 576, 74620)])
def test_headline_backward_keeps_three_blocks_at_every_slab_cap(
    slab_cap, chunk, smem):
  """F 3 with heuristics (13 columns), w_max 58: the uniform cells' 512 in
  one chunk, 61,308 B as before; the heavy scene's 1792 in chunks of 576,
  74,620 B in place of the whole slab's 210,812 (one block an SM)."""
  plan = sk.stream_backward_plan(3, slab_cap, 58, 13, 256)
  assert sk.stream_backward_chunk(3, slab_cap, 58, 13, 256) == chunk
  assert tuple(plan) == (6, 256, smem)
  assert cb.blocks_by_smem(plan.smem) == 3
  assert k2_blocks(3, 1792, 1792, 256)[0] == 210812
  assert cb.blocks_by_smem(210812) == 1


@pytest.mark.parametrize("kernel,plan,cap", [
    ("K1", lambda cap, pix: sk.stream_forward_plan(3, cap, 27, pix), 512),
    ("K4", lambda cap, pix: kk.sorted_forward_plan(3, cap, pix), 128)])
@pytest.mark.parametrize("tile_area", [16, 64, 256, 1024])
def test_forward_plans_hold_one_row_list_a_warp(kernel, plan, cap,
                                                tile_area):
  """K1's and K4's per-warp row lists: one 16-bit entry a slab or chunk
  row for every warp of the block, so a row more adds 2 B a warp beside
  the row's 4-byte terms (the padding warp of a 16-pixel tile included)."""
  warps = cb.block_threads(tile_area) // 32
  grown = plan(cap + 1, tile_area).smem - plan(cap, tile_area).smem
  terms = 4 * (4 + 7 + 3) + (4 * warps if kernel == "K4" else 0)
  # K1's rank keys stay at the next power of two (512 -> 1024 at 513)
  keys = 4 * (1024 - 512) if kernel == "K1" else 0
  assert grown == terms + 2 * warps + keys


@pytest.mark.parametrize("f", [3, 56, 100])
def test_tiles_above_256_pixels_take_the_generic_instantiation(f):
  plans = headline_plans(f, 1024)
  assert all(p[0] == 0 and p[1] == 1024 for p in plans.values()), plans


@pytest.mark.parametrize("widths,picks", [
    (sk.K1_WIDTHS, {1: 4, 4: 4, 5: 8, 8: 8, 9: 24, 24: 24, 25: 56, 56: 56,
                    57: 0}),
    (sk.K2_WIDTHS, {1: 6, 6: 6, 7: 22, 22: 22, 23: 56, 56: 56, 57: 0}),
    (kk.K4_WIDTHS, {1: 4, 4: 4, 5: 8, 8: 8, 9: 24, 24: 24, 25: 56, 56: 56,
                    57: 0}),
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
  assert sk.launch_counts == {"stream_forward": 0, "stream_backward": 0,
                              "stream_backward_chunked": 0, "halo_merge": 0,
                              "stream_descriptors": 0}
  assert kk.launch_counts == {"sorted_forward": 0, "sorted_backward": 0}
