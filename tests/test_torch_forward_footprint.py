"""The forward kernels' per-warp walk (K1, K4), in plain torch (no card).

K1 and K4 give each row a footprint rectangle outside which its raw alpha
stays at or below ``alpha_threshold`` (``csrc/kernel_common.cuh``,
``quad_footprint``), and each warp walks only the rows whose footprint
meets its pixels.  Here:

* the footprint's plain twin ``kernels.footprint_reference`` is
  conservative: brute force over the tile's pixel centres with the twins'
  own alpha formula, in the centred basis (K1) and the tile-local one
  (K4), at f32 and f64, on random rows from a seed and on the edge cases
  (point alpha at or below the threshold, sigma 0.05 and 110 px, axes at
  0, 45 and 90 degrees, centres on and far off the tile); and it is
  tight where it should be (empty, or under a pixel wide);
* a plain model of the skip walk -- the twins with the alpha of every
  (row, pixel) pair whose warp does not walk the row set to 0 -- gives
  the twins' images and K4's visibility bit for bit, on small stream and
  sorted mappings at tiles 16 and 8 (8x4 blocks a warp) and 4 (one warp,
  half of it padding), in blending and quantile modes, on uniform and
  heavy statistics; and the walk masks over a mapping that
  ``chip_smoke.py`` takes its walked shares from count the very (row,
  warp) pairs that model walks on the twins' valid rows;
* the thread-to-pixel map and the floor probes' plain versions.

The kernels themselves are held against the twins on the card
(``test_torch_gpu.py``, ``chip_smoke.py``).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import chip_smoke
from tpu_splatting_torch import (RasterConfig, calibrate_stream, map_to_tiles,
                                 stream_map)
from tpu_splatting_torch.mapper.tile_mapper import calibrate_mapper
from tpu_splatting_torch.rasterizer import kernels as kk
from tpu_splatting_torch.rasterizer import stream_kernels as sk
from tpu_splatting_torch.scenes import heavy_scene, uniform_scene
from tpu_splatting_torch.utils import cuda_build as cb

THR = RasterConfig().alpha_threshold


def family_rows(family, rng, n=400):
  """(n, 7) f64 rows [mean x, mean y, axis x, axis y, sigma x, sigma y,
  point alpha], the mean relative to the tile's corner (16 px tile)."""
  ang = rng.uniform(0.0, np.pi, n)
  mean = rng.uniform(-24.0, 40.0, (n, 2))
  sig = np.exp(rng.uniform(np.log(0.05), np.log(110.0), (n, 2)))
  pa = rng.uniform(0.0, 1.0, n)
  if family == "threshold_alpha":
    pa = THR * rng.choice([0.5, 1.0, 1.0 - 1e-7, 1.0 + 1e-7], n)
  elif family == "sigma_0.05":
    sig[:] = 0.05
    mean = rng.uniform(0.0, 16.0, (n, 2))
    mean[::2] = np.floor(mean[::2]) + 0.5      # on a pixel centre
  elif family == "sigma_110":
    sig[:] = 110.0
    mean = rng.uniform(-300.0, 316.0, (n, 2))
  elif family == "axes":
    ang = rng.choice([0.0, np.pi / 4, np.pi / 2], n)
    sig = np.stack([rng.uniform(0.2, 6.0, n), rng.uniform(0.2, 6.0, n)], 1)
  elif family == "far":
    far = rng.uniform(60.0, 3000.0, n) * rng.choice([-1.0, 1.0], n)
    mean[:, rng.integers(0, 2)] = far
  return np.stack([mean[:, 0], mean[:, 1], np.cos(ang), np.sin(ang),
                   sig[:, 0], sig[:, 1], pa], 1)


def brute_force(rows, tile_size, centred, dtype):
  """(footprints (n, 4) f64, raw alpha (n, PIX), pixel x, pixel y): the
  twins' alpha at every pixel centre of a tile whose corner is at 0."""
  r = torch.from_numpy(rows).to(dtype)
  shift = tile_size * 0.5 if centred else 0.0
  pxl, pyl = kk._pixel_basis(tile_size * tile_size, tile_size, dtype, "cpu")
  pxl, pyl = pxl - shift, pyl - shift
  parts = [r[:, 0] - shift, r[:, 1] - shift] + [r[:, i] for i in range(2, 7)]
  rect = kk.footprint_reference(kk.quad_coeffs(*parts), THR,
                                tile_size * (0.5 if centred else 1.0) - 0.5)
  a_raw = kk._qf_alpha_raw(*(x[:, None] for x in parts), pxl, pyl)
  return rect, a_raw, pxl.double(), pyl.double()


FAMILIES = ["random", "threshold_alpha", "sigma_0.05", "sigma_110", "axes",
            "far"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("centred", [True, False], ids=["K1", "K4"])
@pytest.mark.parametrize("family", FAMILIES)
def test_footprint_is_conservative(family, centred, dtype):
  """No pixel centre outside a row's footprint has a_raw > threshold."""
  rng = np.random.default_rng(FAMILIES.index(family))
  for tile_size in (16, 4):
    rows = family_rows(family, rng)
    rect, a_raw, x, y = brute_force(rows, tile_size, centred, dtype)
    inside = ((rect[:, None, 0] <= x) & (x <= rect[:, None, 1])
              & (rect[:, None, 2] <= y) & (y <= rect[:, None, 3]))
    hit = a_raw > THR
    assert not bool((hit & ~inside).any()), (family, tile_size)
    if family == "threshold_alpha":
      # point alpha at or below the threshold: no pixel to composite; at
      # half of it the peak lies under the level, so nothing to walk
      assert not bool(hit.any())
      low = torch.from_numpy(rows[:, 6] < 0.75 * THR)
      assert bool(low.any()) and bool((rect[low, 0] > rect[low, 1]).all())
    if family == "sigma_0.05":
      # a splat a tenth of a pixel wide covers under a pixel
      assert bool(((rect[:, 1] - rect[:, 0]) < 1.0).all())
      assert bool(hit.any())


def test_footprint_edge_cases():
  """Degenerate forms: not negative definite or not finite -> the whole
  plane; a peak under the level -> empty; an isotropic splat -> a square
  centred on its mean, of the threshold radius plus the margins."""
  inf = math.inf
  whole = [-inf, inf, -inf, inf]
  t = torch.tensor

  def fp(*c):
    return kk.footprint_reference([t([v]) for v in c], THR, 7.5)[0].tolist()
  assert fp(0.0, 0.0, 0.0, 0.0, 0.0, 0.0) == whole       # flat
  assert fp(-1.0, 4.0, -1.0, 0.0, 0.0, 0.0) == whole     # saddle
  assert fp(-1.0, 0.0, -1.0, 0.0, 0.0, math.nan) == whole
  assert fp(-1.0, 0.0, -1.0, 0.0, 0.0, -10.0) == [inf, -inf, inf, -inf]
  sigma, pa = 2.0, 0.5
  coeffs = kk.quad_coeffs(t([1.0]).double(), t([-2.0]).double(),
                          t([1.0]).double(), t([0.0]).double(),
                          t([sigma]).double(), t([sigma]).double(),
                          t([pa]).double())
  x0, x1, y0, y1 = kk.footprint_reference(coeffs, THR, 7.5)[0].tolist()
  radius = sigma * math.sqrt(2.0 * math.log(pa / THR))
  assert x0 < 1.0 - radius and x1 > 1.0 + radius
  assert y0 < -2.0 - radius and y1 > -2.0 + radius
  assert x1 - 1.0 == pytest.approx(radius, rel=1e-3)
  assert x1 - 1.0 == pytest.approx(1.0 - x0, rel=1e-12)


@pytest.mark.parametrize("tile_size", [16, 8, 24, 32])
def test_warps_hold_8x4_blocks(tile_size):
  """At tiles of a multiple of 8 each warp holds an 8x4 block, and the map
  is a permutation of the tile's pixels."""
  pix = tile_size * tile_size
  blocks = kk.thread_pixels(tile_size, pix)
  assert sorted(blocks.tolist()) == list(range(pix))
  wr = kk.warp_rects(tile_size, pix, centred=False)
  assert torch.equal(wr[:, 1] - wr[:, 0], torch.full((pix // 32,), 7.0,
                                                     dtype=torch.float64))
  assert torch.equal(wr[:, 3] - wr[:, 2], torch.full((pix // 32,), 3.0,
                                                     dtype=torch.float64))


def test_padding_lanes_map_to_no_pixel():
  """Tile 4 (16 pixels) in one warp: lanes 16-31 are padding, and the
  warp's rectangle spans the tile's pixel centres only."""
  assert kk.thread_pixels(4, 32).tolist() == list(range(16)) + [-1] * 16
  assert kk.warp_rects(4, 32, centred=True).tolist() == [
      [-1.5, 1.5, -1.5, 1.5]]


# --- the skip walk against the twins -------------------------------------

SIZE = (128, 96)
MODES = {"blend": dict(),
         "quantile": dict(use_alpha_blending=False, saturate_threshold=0.25)}
TILES = (16, 8, 4)
SCENES = {"uniform": (uniform_scene, 3000), "heavy": (heavy_scene, 1500)}


def scene(name, depth_features):
  gen, n = SCENES[name]
  packed, depth, feats = (torch.from_numpy(x) for x in gen(
      np.random.default_rng(4), n, SIZE))
  return packed, depth, depth[:, None] if depth_features else feats


def warp_of_pixel(tile_size):
  """(PIX,) the warp of the thread that composites each pixel."""
  pix = kk.thread_pixels(tile_size, cb.block_threads(tile_size * tile_size))
  out = torch.empty(tile_size * tile_size, dtype=torch.long)
  live = pix >= 0
  out[pix[live]] = torch.arange(pix.numel())[live] // 32
  return out


def skipping(tile_size, centred, walked, valid):
  """alpha_raw with each (row, pixel) pair whose warp does not walk the row
  set to 0: the twins' arithmetic on the rows each warp lists.  ``walked``
  collects (walked pairs, pairs, walked pairs on valid rows), where
  ``valid["rows"]`` is the valid-row mask of the rows being evaluated."""
  wr = kk.warp_rects(tile_size, cb.block_threads(tile_size * tile_size),
                     centred)
  warp = warp_of_pixel(tile_size)
  reach = tile_size * (0.5 if centred else 1.0) - 0.5

  def model(a_raw, coeffs):
    rect = kk.footprint_reference(coeffs, THR, reach)
    mask = kk.walk_mask(rect, wr)
    live = valid["rows"].reshape(mask.shape[:-1])[..., None]
    walked.append((int(mask.sum()), mask.numel(), int((mask & live).sum())))
    return torch.where(mask[..., warp], a_raw, 0.0)
  return model


@pytest.mark.parametrize("scene_name", sorted(SCENES))
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("tile_size", TILES)
def test_stream_skip_walk_equals_twin(monkeypatch, tile_size, mode,
                                      scene_name):
  config = RasterConfig(tile_size=tile_size, **MODES[mode])
  packed, depth, feats = scene(scene_name, "quantile" == mode)
  cal = calibrate_stream(packed, depth, feats, SIZE, config, group_width=8)
  m = stream_map(packed, depth, feats, SIZE, config, group_width=8,
                 **{k: cal[k] for k in ("num_slabs", "strip_cap", "slab_cap",
                                        "w_max", "run_cap", "wide_cap",
                                        "dup_cap")})
  want = sk.stream_forward_reference(m, config)
  walked, valid = [], {}
  model = skipping(tile_size, True, walked, valid)
  orig = sk._alpha_raw
  orig_rows = sk._slab_rows

  def slab_rows(*args, **kwargs):
    out = orig_rows(*args, **kwargs)
    valid["rows"] = out[0]
    return out
  monkeypatch.setattr(sk, "_slab_rows", slab_rows)

  def alpha(rows, ox, oy, pxl, pyl, cfg):
    a_raw, aux = orig(rows, ox, oy, pxl, pyl, cfg)
    coeffs = kk.quad_coeffs(rows[..., 0] - ox, rows[..., 1] - oy,
                            *(rows[..., i] for i in range(2, 7)))
    return model(a_raw, coeffs), aux
  monkeypatch.setattr(sk, "_alpha_raw", alpha)
  got = sk.stream_forward_reference(m, config)
  assert float(want[:, :-1].abs().max()) > 0.1
  assert torch.equal(got, want)
  done, pairs, done_valid = map(sum, zip(*walked))
  assert 0 < done < pairs, (done, pairs)
  # the walk mask over the mapping counts the pairs the model walked on
  # the valid rows of every slab the twin evaluates (padding slots out)
  share = chip_smoke.stream_walk_mask(m, config)
  assert share.shape[1] == cb.block_threads(config.tile_area) // 32
  assert int(share.sum()) == done_valid, (int(share.sum()), done_valid)
  assert 0.0 < float(share.double().mean()) < 1.0


@pytest.mark.parametrize("scene_name", sorted(SCENES))
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("tile_size", TILES)
def test_sorted_skip_walk_equals_twin(monkeypatch, tile_size, mode,
                                      scene_name):
  # heavy splats reach 110 px: a big-path window as wide as the image
  config = RasterConfig(tile_size=tile_size, chunk_size=32,
                        big_tile_window=SIZE[0] // tile_size, **MODES[mode])
  packed, depth, feats = scene(scene_name, "quantile" == mode)
  cal = calibrate_mapper(packed, depth, SIZE, config)
  config = dataclasses.replace(config, tile_window=cal["tile_window"],
                               big_capacity=cal["big_capacity"])
  m = map_to_tiles(packed, depth, SIZE, config,
                   max_overlaps=cal["max_overlaps"], features=feats)
  assert int(m.num_overflow) == 0
  args = (m.sorted_payload, m.chunk_src, m.chunk_cnt, m.chunk_to_tile,
          config, m.num_tiles, m.tiles_wide)
  want_img, want_vis = kk.forward_reference(*args)
  walked, valid = [], {}
  model = skipping(tile_size, False, walked, valid)
  orig = kk._alpha_raw
  orig_chunks = kk._Chunks.chunks

  def chunks(self, tiles):
    for item in orig_chunks(self, tiles):
      valid["rows"] = item[2]
      yield item
  monkeypatch.setattr(kk._Chunks, "chunks", chunks)

  def alpha(parts, pxl, pyl, antialias):
    a_raw, aux = orig(parts, pxl, pyl, antialias)
    coeffs = [c[..., 0] for c in kk.quad_coeffs(*parts)]
    return model(a_raw, coeffs), aux
  monkeypatch.setattr(kk, "_alpha_raw", alpha)
  got_img, got_vis = kk.forward_reference(*args)
  assert float(want_img[:, :-1].abs().max()) > 0.1
  assert torch.equal(got_img, want_img)
  assert torch.equal(got_vis, want_vis)
  done, pairs, done_valid = map(sum, zip(*walked))
  assert 0 < done < pairs, (done, pairs)
  share = chip_smoke.sorted_walk_mask(*args)
  assert share.shape == (int(m.chunk_cnt.sum()),
                         cb.block_threads(config.tile_area) // 32)
  assert int(share.sum()) == done_valid, (int(share.sum()), done_valid)
  assert 0.0 < float(share.double().mean()) < 1.0


def test_antialias_walks_every_row():
  config = RasterConfig(antialias=True)
  packed, depth, feats = scene("uniform", False)
  m = map_to_tiles(packed, depth, SIZE, config, max_overlaps=200_000,
                   features=feats)
  share = chip_smoke.sorted_walk_mask(
      m.sorted_payload, m.chunk_src, m.chunk_cnt, m.chunk_to_tile, config,
      m.num_tiles, m.tiles_wide)
  assert bool(share.all())


# --- the floor probes' plain versions --------------------------------------

def test_floor_probes_on_the_cpu_take_their_plain_versions():
  """On the CPU each floor wrapper returns its plain version: K4's writes
  column 0 of each tile's last chunk's first row to channel 0 (tiles
  without chunks and the dummy tile stay 0); K1's the rows each tile
  staged.  No launch is counted."""
  config = RasterConfig(chunk_size=32)
  packed, depth, feats = scene("uniform", False)
  m = map_to_tiles(packed, depth, SIZE, config, max_overlaps=200_000,
                   features=feats)
  kk.reset_launch_counts()
  img = kk.forward_floor(m.sorted_payload, m.chunk_src, m.chunk_cnt,
                         m.chunk_to_tile, config, m.num_tiles, m.tiles_wide)
  assert img.shape == (m.num_tiles + 1, 4, config.tile_area)
  tiles = m.chunk_to_tile.tolist()
  for t in range(m.num_tiles):
    ks = [k for k, tt in enumerate(tiles) if tt == t]
    want = float(m.sorted_payload[int(m.chunk_src[ks[-1]]), 0]) if ks else 0.
    assert bool((img[t, 0] == want).all()), t
  assert not bool(img[:, 1:].any()) and not bool(img[-1].any())
  assert kk.probe_launch_counts == {"sorted_forward_floor": 0}

  cal = calibrate_stream(packed, depth, feats, SIZE, config, group_width=8)
  sm = stream_map(packed, depth, feats, SIZE, config, group_width=8,
                  **{k: cal[k] for k in ("num_slabs", "strip_cap",
                                         "slab_cap", "w_max", "run_cap",
                                         "wide_cap", "dup_cap")})
  sk.reset_launch_counts()
  out = sk.stream_forward_floor(sm, config)
  # an empty plan slot has no rows: every window row is staged
  rows = sk._window_slots(sm)[1].sum((1, 2))
  assert torch.equal(out[:, 0, 0], rows.to(out.dtype))
  assert not bool(out[:, 1:].any())
  assert not any(sk.probe_launch_counts.values())
