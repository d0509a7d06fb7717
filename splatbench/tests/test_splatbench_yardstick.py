"""The yardstick's arithmetic: the frozen scenes against the program's
generators, the operation and byte counts, the listing and its order, the
readers, on the CPU."""

from __future__ import annotations

import sys

import numpy as np
import pytest
import torch

from splatbench import harness, readers, roofline, scenes
from splatbench.reference import raster


class NumpyDraws:
  """The ``Draws`` interface over a numpy Generator: the port's own
  draws, in float64, as its scene generators make them."""

  def __init__(self, rng):
    self.rng = rng

  def random(self, shape):
    return torch.from_numpy(self.rng.random(shape))

  def uniform(self, lo, hi, shape):
    return torch.from_numpy(np.asarray(self.rng.uniform(lo, hi, shape)))

  def normal(self, mu, sigma, shape):
    return torch.from_numpy(np.asarray(self.rng.normal(mu, sigma, shape)))

  def integers(self, high, shape):
    return torch.from_numpy(self.rng.integers(0, high, shape))


@pytest.mark.parametrize("name", ["uniform_scene", "heavy_scene"])
def test_frozen_scene_reproduces_the_port(name):
  from tpu_splatting_torch import scenes as port
  size = (256, 192)
  want = getattr(port, name)(np.random.default_rng(5), 3000, size)
  got = getattr(scenes, name)(NumpyDraws(np.random.default_rng(5)), 3000,
                              size)
  for g, w in zip(got, want):
    assert g.dtype == torch.float32
    torch.testing.assert_close(g, torch.from_numpy(w), rtol=1e-6, atol=1e-6)


def test_frozen_lift_reproduces_the_port():
  from tpu_splatting_torch import scenes as port
  size = (256, 192)
  packed, depth, feats = port.uniform_scene(np.random.default_rng(6), 2000,
                                            size)
  g3d, cam = port.lift_to_3d(packed, depth, feats, size, near=0.1, far=100.0,
                             fov_deg=70.0, device="cpu")
  leaves, intr = scenes.lift_to_3d(
      NumpyDraws(np.random.default_rng(3)), torch.from_numpy(packed),
      torch.from_numpy(depth), torch.from_numpy(feats), size, 0.1, 100.0,
      70.0)
  for g, w in zip(leaves, (g3d.position, g3d.log_scaling, g3d.rotation,
                           g3d.alpha_logit, g3d.feature)):
    torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
  torch.testing.assert_close(torch.tensor(intr, dtype=torch.float32),
                             cam.projection)


def test_entile_round_trip():
  img = torch.rand(40, 56, 3)
  tiled = scenes.entile(img, 16)
  assert tiled.shape == (12, 3, 256)
  torch.testing.assert_close(scenes.detile(tiled, (56, 40), 16), img)
  # tile 1 is the second tile of the first row: pixels x 16..31, y 0..15
  torch.testing.assert_close(tiled[1, :, 17], img[1, 17])


def test_operation_counts_by_hand():
  # K1 with F = 3: alpha 11, threshold 2, exp 1, weight 1, features 6,
  # weight sum 1, log1p and add 2
  assert roofline.k1_ops_per_pair(3) == 24
  # K2: 24 - 11 + 14 + 7 + 4 + 4 + 2 + 2 + 4 + 3 + 1 + 9 + 13 columns
  assert roofline.k2_ops_per_pair(3) == 76
  # 1000 pairs on 10 tiles: 6,144,000 operations (91.7 ns at 67 TFLOP/s)
  # against 4 * (1000 * 11 + 10 * 4 * 256) = 84,960 bytes (25.4 ns)
  least = roofline.least_seconds(1000 * 256 * 24,
                                 roofline.k1_bytes(1000, 10, 3))
  assert least == pytest.approx(6_144_000 / 67e12)
  assert roofline.k1_bytes(1000, 10, 3) == 84_960
  assert roofline.share(least, 2 * least) == pytest.approx(50.0)
  assert roofline.share(least, 0.0) is None
  # a training step of 10 pairs and 4 projected, shaded splats
  assert roofline.step_ops(10, 3, 4, True, True, True) == (
      10 * 256 * 100 + 4 * 280 * 3)


def test_listing_counts_and_order():
  """Splat 0 at (24, 24), 3-px sigma, alpha 0.9: cull radius 3.31 sigma,
  so its box [14.1, 33.9]^2 meets tiles 0..2 on each axis: 9 pairs.
  Splats 1 and 2 share its 14-bit depth.  Splat 1 (box [14.1, 33.9] x
  [-1.9, 17.9]: 6 pairs) is homed in the tile row above tile (1, 1) and
  reaches down into it; splat 2 (1 pair) is homed in tile (1, 1).  So in
  tile (1, 1) the order among the tie is 1 (home row above), then 2 and
  0 (same home, by reach: 2 reaches nowhere, 0 both ways), and splat 3
  (deeper, 1 pair) last."""
  packed = torch.tensor([
      [24.0, 24.0, 1.0, 0.0, 3.0, 3.0, 0.9],
      [24.0, 8.0, 1.0, 0.0, 3.0, 3.0, 0.9],
      [24.0, 24.0, 1.0, 0.0, 0.5, 0.5, 0.9],
      [20.0, 20.0, 1.0, 0.0, 1.0, 1.0, 0.9]])
  depth = torch.tensor([0.5, 0.5, 0.5, 0.6])
  assert raster.count_pairs(packed, depth, (48, 48), 1 / 255) == 9 + 6 + 1 + 1
  pairs = raster.bin_splats(packed, depth, (48, 48), 1 / 255)
  tile = 1 * 3 + 1
  got = pairs.splat[pairs.starts[tile]:pairs.starts[tile + 1]].tolist()
  assert got == [1, 2, 0, 3]


def test_readers_read_nothing_without_a_trace():
  ctx = {"op_ms": 10.0, "calibrate_s": 1.5, "timer": harness.Timer(False)}
  assert readers.k1_roofline(ctx) is None
  assert readers.idle_share(ctx) is None
  assert readers.mfu(ctx) is None
  assert harness.metric_reader("calibrate_s")(ctx) == 1.5
  assert harness.metric_reader("optimizer_ms.train")(ctx) is None


def test_readers_from_a_session():
  pairs, tiles = 1_000_000, 12_288
  least = roofline.least_seconds(pairs * 256 * 24,
                                 roofline.k1_bytes(pairs, tiles, 3))
  # 15 ms busy per op against an op of 20 ms in the window: 25% idle
  session = {"ops": 3, "busy_s": 0.045, "window_s": 0.08,
             "kernels": {"void stream_forward_headline_kernel<4>(Params)":
                         3 * 4 * least, "other": 1.0}}
  ctx = {"session": session, "op_ms": 20.0,
         "work": {"pairs": pairs, "tiles": tiles, "features": 3,
                  "ops": 2.68e11}}
  assert readers.k1_roofline(ctx) == pytest.approx(25.0)
  assert readers.k2_roofline(ctx) is None
  assert readers.idle_share(ctx) == pytest.approx(25.0)
  assert readers.mfu(ctx) == pytest.approx(100 * 2.68e11 / 0.02 / 67e12)


def test_forbidden_modules_compares_whole_names(monkeypatch):
  monkeypatch.setitem(sys.modules, "tpu_splatting_torch_x", sys)
  assert "tpu_splatting" not in harness.forbidden_modules()
  monkeypatch.setitem(sys.modules, "tpu_splatting.sub", sys)
  assert harness.forbidden_modules() == ["tpu_splatting"]


def test_quantile95():
  assert harness.quantile95(list(range(101))) == pytest.approx(95.0)
