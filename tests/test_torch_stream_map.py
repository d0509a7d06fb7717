"""Port vs reference: the stream mapper.

On scenes without sort-key ties (distinct depth keys), every integer
field of ``StreamMapping`` and the per-cause overflow counts must equal
the JAX mapper's exactly, and the table to 1e-7.  ``calibrate_stream``
must return the same dict.
"""

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import port_compare as pc  # noqa: E402
from random_data import random_2d_gaussians  # noqa: E402
from test_stream import TIGHT, make_scene  # noqa: E402
from tpu_splatting import RasterConfig  # noqa: E402
from tpu_splatting.misc.renderer2d import project_gaussians2d  # noqa: E402
from tpu_splatting.rasterizer import stream as jstream  # noqa: E402
from tpu_splatting_torch.rasterizer import stream as tstream  # noqa: E402

CONFIG = RasterConfig(tile_size=8, chunk_size=8)


def both(packed, depths, feats, image_size, config=CONFIG, **kw):
  mj = jstream.stream_map(jnp.asarray(packed, jnp.float32),
                          jnp.asarray(depths, jnp.float32),
                          jnp.asarray(feats, jnp.float32), image_size,
                          config, **kw)
  mt = tstream.stream_map(pc.t(packed, torch.float32),
                          pc.t(depths, torch.float32),
                          pc.t(feats, torch.float32), image_size,
                          pc.config(config), **kw)
  return mj, mt


def wide_scene():
  """Eight ~30 px splats reach far beyond +-1 tile of home: duplicates."""
  rng = np.random.default_rng(11)
  n, image_size = 60, (64, 48)
  g2 = random_2d_gaussians(rng, n, image_size, num_channels=3,
                           scale_factor=0.4, alpha_range=(0.2, 0.9),
                           dtype=jnp.float32)
  packed = np.array(project_gaussians2d(g2), copy=True)
  packed[:8, 4:6] = rng.uniform(20.0, 35.0, (8, 2))
  depths = (rng.permutation(n).astype(np.float32) + 0.5) / n
  return packed, depths, np.asarray(g2.feature), image_size


def deep_tile_scene():
  """One ~700-row home run in a single depth cell: merged windows longer
  than STRIP_SLACK rows split into several descriptors."""
  rng = np.random.default_rng(5)
  n = 700
  packed = np.zeros((n, 7), np.float32)
  packed[:, 0] = rng.uniform(1.5, 6.5, n)
  packed[:, 1] = rng.uniform(1.5, 6.5, n)
  theta = rng.uniform(0, np.pi, n)
  packed[:, 2] = np.cos(theta)
  packed[:, 3] = np.sin(theta)
  packed[:, 4:6] = rng.uniform(0.3, 0.6, (n, 2))
  packed[:, 6] = rng.uniform(0.2, 0.5, n)
  depths = (rng.permutation(n).astype(np.float32) + 0.5) / n
  feats = rng.random((n, 3)).astype(np.float32)
  return packed, depths, feats


@pytest.mark.parametrize("case", ["tight", "wide", "depth12", "chunked"])
def test_stream_map_matches_reference(case):
  if case == "tight":
    packed, depths, feats = make_scene(0, 80, (32, 24))
    mj, mt = both(packed, depths, feats, (32, 24), group_width=2, **TIGHT)
  elif case == "wide":
    packed, depths, feats, size = wide_scene()
    config = RasterConfig(tile_size=8, chunk_size=8, big_tile_window=16)
    mj, mt = both(packed, depths, feats, size, config, group_width=2,
                  wide_cap=64, dup_cap=512, **TIGHT)
    assert int(np.asarray(mj.dup_pid < mj.num_points).sum()) > 0
  elif case == "depth12":
    packed, _, feats = make_scene(21, 60, (32, 24))
    rng = np.random.default_rng(21)
    depths = (rng.permutation(60).astype(np.float32) + 0.5) / 60
    mj, mt = both(packed, depths, feats, (32, 24), group_width=2,
                  depth_bits=12, **TIGHT)
    assert mt.depth_bits == 12
  else:
    packed, depths, feats = deep_tile_scene()
    caps = dict(num_slabs=1, strip_cap=512, slab_cap=768, w_max=8,
                run_cap=1024, group_width=2)
    mj, mt = both(packed, depths, feats, (16, 8), **caps)
    desc = mt.desc.numpy().reshape(mt.num_groups, 2, 1, 8, 4)
    assert int(desc[..., 1].max()) == (tstream.STRIP_SLACK
                                       - mt.rows_per_block)
  assert int(mt.num_overflow) == 0
  pc.assert_mappings_equal(mj, mt)


def test_stream_map_overflow_by_cause():
  """Dropped rows are counted by cause exactly as the reference counts
  them: wide splats with duplication off, and a tiny slab_cap."""
  rng = np.random.default_rng(13)
  n, image_size = 40, (64, 48)
  g2 = random_2d_gaussians(rng, n, image_size, num_channels=3,
                           scale_factor=0.3, alpha_range=(0.3, 0.9),
                           dtype=jnp.float32)
  packed = np.array(project_gaussians2d(g2), copy=True)
  packed[:5, 0:2] = np.asarray([[32.0, 24.0]] * 5)
  packed[:5, 4:6] = 20.0
  packed[5:, 4:6] = 1.0
  depths = (rng.permutation(n).astype(np.float32) + 0.5) / n
  feats = np.asarray(g2.feature)
  mj, mt = both(packed, depths, feats, image_size, group_width=2,
                num_slabs=2, strip_cap=128, slab_cap=64, w_max=16,
                run_cap=16, dup_cap=0)
  assert mt.overflow.tolist() == [5, 0, 0, 0, 0]
  pc.assert_mappings_equal(mj, mt)
  mj, mt = both(packed, depths, feats, image_size, group_width=2,
                num_slabs=1, strip_cap=128, slab_cap=8, w_max=16,
                run_cap=16, dup_cap=512)
  assert int(mt.overflow[2]) > 0
  pc.assert_mappings_equal(mj, mt)


def test_calibrate_stream_matches_reference():
  packed, depths, feats = make_scene(0, 80, (32, 24))
  cal_j = jstream.calibrate_stream(packed, depths, feats, (32, 24), CONFIG,
                                   group_width=2)
  cal_t = tstream.calibrate_stream(pc.t(packed), pc.t(depths), pc.t(feats),
                                   (32, 24), pc.config(CONFIG),
                                   group_width=2)
  assert cal_t == cal_j
  assert cal_t["overflow"] == [0, 0, 0, 0, 0]


def test_stream_map_constants():
  assert tstream.CAPACITY_SEMANTICS == jstream.CAPACITY_SEMANTICS
  assert tstream.OVERFLOW_CAUSES == jstream.OVERFLOW_CAUSES
  assert tstream.STRIP_SLACK == jstream.STRIP_SLACK
  for w in (11, 12, 32, 33, 64, 65):
    assert tstream.rows_per_block_for(w) == jstream.rows_per_block_for(w)
  for t in (1, 16383, 16384, 49152):
    assert tstream.depth_bits_for(t) == jstream.depth_bits_for(t)


UNBOUNDED = dict(strip_cap=1 << 27, slab_cap=1 << 27, run_cap=1 << 27,
                 build_table=False)


@pytest.mark.parametrize("case", ["unbounded_slab", "unbounded_long_runs",
                                  "window_overflow", "run_overflow",
                                  "one_slab_window_overflow"])
def test_stream_map_descriptor_edges(case):
  """The descriptor pipeline's edges that the card's kernel is held to:
  calibration's unbounded pass (slab_cap > 2048: one piece a window, a
  run longer than a piece counted as window overflow), windows past
  w_max, runs past run_cap, and one slab."""
  if case == "unbounded_long_runs":
    packed, depths, feats = deep_tile_scene()
    mj, mt = both(packed, depths, feats, (16, 8), num_slabs=1, w_max=8,
                  group_width=2, **UNBOUNDED)
  else:
    packed, depths, feats = make_scene(0, 80, (32, 24))
    kw = {"unbounded_slab": dict(UNBOUNDED, num_slabs=4, w_max=72),
          "window_overflow": dict(TIGHT, w_max=2),
          "run_overflow": dict(TIGHT, run_cap=4),
          "one_slab_window_overflow": dict(TIGHT, num_slabs=1, w_max=3),
          }[case]
    mj, mt = both(packed, depths, feats, (32, 24), group_width=2, **kw)
  cause = {"unbounded_long_runs": 4, "window_overflow": 4, "run_overflow": 3,
           "one_slab_window_overflow": 4}.get(case)
  if cause is not None:
    assert int(mt.overflow[cause]) > 0
  pc.assert_mappings_equal(mj, mt)
