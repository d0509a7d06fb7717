"""Port vs reference: the sorted-pipeline tile mapper.

``map_to_tiles`` of tpu_splatting_torch against tpu_splatting's on the
same numpy inputs: every integer field exactly (``overlap_to_point``,
``tile_ranges``, ``chunk_to_tile``, ``chunk_src``, ``chunk_cnt``,
``num_overflow``), ``sorted_payload`` to 1e-7, with and without
features, on the big path and with overflow by each cause; and
``calibrate_mapper``'s dict.  Both mappers sort stably, so ties in depth
are ordered alike.
"""

import dataclasses

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import port_compare as pc  # noqa: E402
from random_data import random_2d_gaussians  # noqa: E402
from tpu_splatting import RasterConfig  # noqa: E402
from tpu_splatting.mapper import tile_mapper as jmap  # noqa: E402
from tpu_splatting.misc.renderer2d import project_gaussians2d  # noqa: E402
from tpu_splatting_torch.mapper import tile_mapper as tmap  # noqa: E402


def scene(seed, n=60, image_size=(64, 48), scale_factor=0.5,
          dtype=jnp.float32):
  rng = np.random.default_rng(seed)
  g2 = random_2d_gaussians(rng, n, image_size, scale_factor=scale_factor,
                           dtype=dtype)
  return (np.array(project_gaussians2d(g2)), np.array(g2.depths),
          np.array(g2.feature))


def both(packed, depth, feats, image_size, config, max_overlaps):
  mj = jmap.map_to_tiles(jnp.asarray(packed), jnp.asarray(depth), image_size,
                         config, max_overlaps=max_overlaps,
                         features=None if feats is None
                         else jnp.asarray(feats))
  mt = tmap.map_to_tiles(pc.t(packed), pc.t(depth), image_size, config,
                         max_overlaps=max_overlaps,
                         features=None if feats is None else pc.t(feats))
  return mj, mt


CASES = {
    # name: (scene kwargs, config kwargs, max_overlaps, overflows,
    #        with features)
    "tight": (dict(), dict(tile_size=16), 4096, False, True),
    "tight_nofeat": (dict(), dict(tile_size=16), 4096, False, False),
    "tile8": (dict(n=50, image_size=(32, 24), scale_factor=1.0),
              dict(tile_size=8), 1024, False, False),
    "f64": (dict(dtype=jnp.float64), dict(tile_size=16), 4096, False, True),
    "big_path": (dict(scale_factor=1.5), dict(tile_size=8, tile_window=1),
                 8192, False, True),
    "over_capacity": (dict(scale_factor=2.0), dict(tile_size=16), 64, True,
                      False),
    "over_big_capacity": (dict(scale_factor=1.5),
                          dict(tile_size=8, tile_window=1, big_capacity=4),
                          8192, True, False),
    "span_clipped": (dict(scale_factor=3.0),
                     dict(tile_size=8, tile_window=1, big_tile_window=2),
                     8192, True, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_map_to_tiles_matches_reference(case):
  scene_kw, cfg_kw, cap, overflows, with_features = CASES[case]
  size = scene_kw.get("image_size", (64, 48))
  packed, depth, feats = scene(3, **scene_kw)
  config = RasterConfig(chunk_size=8, **cfg_kw)
  mj, mt = both(packed, depth, feats if with_features else None, size,
                config, cap)
  assert (int(mj.num_overflow) > 0) == overflows
  pc.assert_tile_mappings_equal(mj, mt)
  np.testing.assert_array_equal(mt.point_id_chunked.numpy(),
                                np.asarray(mj.point_id_chunked))
  # the converted reference mapping is the same object field for field
  pc.assert_tile_mappings_equal(mj, pc.tile_mapping(mj))


def test_map_to_tiles_culled_and_tied_depths():
  """Culled points (depth 0) map nowhere; equal depths keep index order."""
  packed, depth, _ = scene(5, n=40)
  depth[:8] = 0.0
  depth[8:20] = depth[8]
  config = RasterConfig(tile_size=16, chunk_size=8)
  mj, mt = both(packed, depth, None, (64, 48), config, 4096)
  pc.assert_tile_mappings_equal(mj, mt)
  assert not np.isin(np.arange(8), mt.overlap_to_point.numpy()).any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_calibrate_mapper_matches_reference(seed):
  """Equal dicts where every point is valid and the two widest spans are
  equal: there the reference's (N, N) span matrix (ROADMAP F9) gives the
  per-point answer."""
  packed, depth, _ = scene(seed)
  config = RasterConfig(tile_size=16, chunk_size=8)
  want = jmap.calibrate_mapper(jnp.asarray(packed), jnp.asarray(depth),
                               (64, 48), config)
  got = tmap.calibrate_mapper(pc.t(packed), pc.t(depth), (64, 48), config)
  assert want["num_valid"] == packed.shape[0]
  assert got == want


def test_calibrate_mapper_counts_each_point_once():
  """ROADMAP F9: the reference broadcasts its (N,) spans against an (N, 1)
  validity mask, so ``num_wide`` counts each wide point once per valid
  point.  The port counts each point once."""
  size = (128, 96)
  packed, depth, _ = scene(4, n=40, image_size=size, scale_factor=1.0)
  config = RasterConfig(tile_size=8, chunk_size=8)
  want = jmap.calibrate_mapper(jnp.asarray(packed), jnp.asarray(depth),
                               size, config)
  got = tmap.calibrate_mapper(pc.t(packed), pc.t(depth), size, config)
  assert got["num_valid"] == want["num_valid"] == 40
  assert got["tile_window"] == 8 == want["tile_window"]
  assert 0 < got["num_wide"] < 40
  assert want["num_wide"] == got["num_wide"] * got["num_valid"]
  m = tmap.map_to_tiles(pc.t(packed), pc.t(depth), size,
                        dataclasses.replace(
                            config, tile_window=got["tile_window"],
                            big_capacity=got["big_capacity"]),
                        max_overlaps=got["max_overlaps"])
  assert int(m.num_overflow) == 0


def overflow_causes(module, g2d, packed, depth, image_size, config):
  """{cause: dropped} of a ``map_to_tiles`` call, from the mapper module's
  own bound helpers: big points past ``big_capacity`` and big points whose
  span exceeds ``big_tile_window`` (clipped, counted once a point)."""
  mean, axis, sigma, alpha = g2d.unpack_g2d(packed)
  gscale = g2d.gaussian_scale(alpha, config.alpha_threshold)
  valid = (alpha > config.alpha_threshold) & (depth > 0) & (gscale > 0)
  lo, hi = module._tile_bounds(mean, axis, sigma, gscale,
                               module.pad_to_tile(image_size,
                                                  config.tile_size),
                               config.tile_size)
  span = np.asarray(hi - lo)
  big = np.asarray(valid) & (span > config.tile_window).any(-1)
  order = np.argsort(np.asarray(depth).view(np.int32), kind="stable")
  kept = order[big[order]][:config.big_capacity]
  return {"big_capacity": max(int(big.sum()) - config.big_capacity, 0),
          "clipped": int((span[kept] > config.big_tile_window).any(-1).sum())}


def test_wide_splats_past_big_tile_window_drop_alike():
  """ROADMAP F19, on the reference's side: ``bench_components``'
  rasterizer scene has almost every splat wider than the tile window and
  most wider than ``big_tile_window`` (16 tiles), which neither
  package's ``calibrate_mapper`` sizes.  At its suggestion both mappers
  clip the same splats and count them in ``num_overflow`` (a point each,
  not its lost overlaps); no other cause drops anything.  With
  ``big_tile_window`` at the widest span both map exactly.  The scene is
  ``synthetic_2d``'s at 300 splats and 512x384 (the same statistics as
  2,000 at 1024x768: all wide, 276 past the big window)."""
  from tpu_splatting.lib import gaussian2d as jg2d
  from tpu_splatting_torch.benchmarks import bench_components as bc
  from tpu_splatting_torch.lib import gaussian2d as tg2d
  size = (512, 384)
  packed, depth, _ = (x.numpy() for x in bc.synthetic_2d(300, size,
                                                         device="cpu"))
  config = RasterConfig(chunk_size=128)
  cal = tmap.calibrate_mapper(pc.t(packed), pc.t(depth), size, config)
  jcal = jmap.calibrate_mapper(jnp.asarray(packed), jnp.asarray(depth),
                               size, config)
  assert cal["num_wide"] == 300 and cal["tile_window"] == 8
  for k in ("tile_window", "max_overlaps", "num_valid"):
    assert cal[k] == jcal[k], k
  config = dataclasses.replace(config, tile_window=cal["tile_window"],
                               big_capacity=cal["big_capacity"])
  mj, mt = both(packed, depth, None, size, config, cal["max_overlaps"])
  want = overflow_causes(jmap, jg2d, jnp.asarray(packed), jnp.asarray(depth),
                         size, config)
  got = overflow_causes(tmap, tg2d, pc.t(packed), pc.t(depth), size, config)
  assert got == want == {"big_capacity": 0, "clipped": 276}
  assert int(mt.num_overflow) == int(mj.num_overflow) == 276
  pc.assert_tile_mappings_equal(mj, mt)
  with pytest.raises(RuntimeError, match="276 overlaps dropped"):
    bc.rasterizer_setup(300, size, device="cpu")

  config = dataclasses.replace(config, big_tile_window=32)   # widest span
  cal = tmap.calibrate_mapper(pc.t(packed), pc.t(depth), size, config)
  mj, mt = both(packed, depth, None, size, config, cal["max_overlaps"])
  assert int(mt.num_overflow) == int(mj.num_overflow) == 0


def test_65535_tiles_assert_as_in_the_reference():
  """Tile keys are 16 bits: 256 x 256 tiles of 16 px are refused."""
  packed, depth, _ = scene(0, n=10)
  config = RasterConfig(tile_size=16, chunk_size=8)
  with pytest.raises(AssertionError, match="16-bit"):
    jmap.map_to_tiles(jnp.asarray(packed), jnp.asarray(depth), (4096, 4096),
                      config)
  with pytest.raises(AssertionError, match="16-bit"):
    tmap.map_to_tiles(pc.t(packed), pc.t(depth), (4096, 4096), config)
  # one tile fewer than the id budget maps
  m = tmap.map_to_tiles(pc.t(packed), pc.t(depth), (4096, 4080), config)
  assert m.num_tiles == 65280


def test_default_max_overlaps_matches_reference():
  config = RasterConfig(tile_size=16, chunk_size=8)
  for n in (10, 5000, 100000):
    assert (tmap.default_max_overlaps(n, (640, 480), config)
            == jmap.default_max_overlaps(n, (640, 480), config))


def test_mapping_is_int32_on_the_port():
  packed, depth, feats = scene(1)
  m = tmap.map_to_tiles(pc.t(packed), pc.t(depth), (64, 48),
                        RasterConfig(tile_size=16, chunk_size=8),
                        max_overlaps=4096, features=pc.t(feats))
  for name in ("overlap_to_point", "tile_ranges", "chunk_to_tile",
               "chunk_src", "chunk_cnt", "num_overflow"):
    assert getattr(m, name).dtype == torch.int32, name
  assert m.sorted_payload.dtype == torch.float32
