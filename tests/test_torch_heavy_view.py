"""The heavy 3DGS-checkpoint scene viewed in 3D at SH degree 3: the
benchmark's ``heavy2m-2048-sh3`` configuration cut to 4,000 splats at
256x192 (``splats`` and ``image_size`` only), lifted and posed as the
``view.heavy2m`` cell does it, capacities from the calibration of every
pose.  The port's ``render_gaussians(..., use_sh=True)`` is held against
the plain reference's ``render3d`` (``splatbench/reference``: plain
torch, its own projection, SH, listing and compositing); the mapping of
each view holds wide splats and duplicate rows, and drops nothing."""

import functools
import json
import os

import pytest
import torch

import tpu_splatting_torch as ts
from splatbench import scenes
from splatbench.loops import common
from splatbench.reference import steps as ref_steps
from tpu_splatting_torch.rasterizer.stream import wide_stats
from tpu_splatting_torch.rasterizer.stream_function import (
    stream_map_with_config)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = (256, 192)
POSES = 3
SEEDS = [3, 2147483651, 4000000007]
# |port - reference| / |reference| over image and weight.  Both sides
# composite in float32 in the same order; they differ by the rounding of
# their own projection, SH and exp (and F20's float32 alpha of thin
# splats), which reads 1.7e-07 to 5.2e-06 on these scenes.  The reference
# composited in bfloat16 reads 0.025 to 0.036, past it by 250x or more.
TOL = 1e-4


def config():
  with open(os.path.join(ROOT, "splatbench", "configs",
                         "heavy2m-2048-sh3.json")) as fh:
    cfg = json.load(fh)
  cfg.update(splats=4000, image_size=list(SIZE))
  return cfg


@functools.lru_cache(maxsize=None)
def view(seed):
  """(config, leaves, intrinsics, poses, cameras, the calibrated
  RasterConfig) of ``seed``'s scene, as the view loop makes them."""
  cfg = config()
  draws = scenes.Draws(seed, "cpu")
  leaves, intr = common.scene_3d(cfg, draws)
  poses = scenes.poses(draws, POSES, 0.001, 1.0)
  g3d = ts.Gaussians3D(*leaves)
  lift = cfg["lift"]
  proj = torch.tensor(intr, dtype=torch.float32)
  cams = [ts.CameraParams(projection=proj, T_camera_world=p,
                          near_plane=lift["near"], far_plane=lift["far"],
                          image_size=SIZE) for p in poses]
  cal = common.calibrate_views(ts, g3d, cams, SIZE, cfg, False)
  rcfg = common.raster_config(ts.RasterConfig, cal, cfg, False)
  return cfg, leaves, intr, poses, cams, rcfg


def reference(seed, pose, dtype):
  cfg, leaves, intr, poses, _, _ = view(seed)
  lift = cfg["lift"]
  res = ref_steps.render3d(leaves, intr, poses[pose], SIZE, lift["near"],
                           lift["far"], dtype=dtype, budget=1 << 22)[0]
  return scenes.detile(res.image.float(), SIZE, cfg["tile_size"])


def rel(got, want):
  return float(torch.linalg.vector_norm((got - want).double())
               / torch.linalg.vector_norm(want.double()))


CASES = [(s, p) for s in SEEDS for p in range(POSES)]


@pytest.mark.parametrize("seed,pose", CASES)
def test_view_matches_the_reference(seed, pose):
  _, leaves, _, _, cams, rcfg = view(seed)
  with torch.no_grad():
    r = ts.render_gaussians(ts.Gaussians3D(*leaves), cams[pose], rcfg,
                            use_sh=True)
  assert int(r.num_overflow) == 0
  got = torch.cat([r.image, r.image_weight[..., None]], -1)
  assert rel(got, reference(seed, pose, torch.float32)) < TOL


@pytest.mark.parametrize("seed", SEEDS)
def test_bfloat16_compositing_fails_the_tolerance(seed):
  want = reference(seed, 0, torch.float32)
  assert rel(reference(seed, 0, torch.bfloat16), want) > 100 * TOL


@pytest.mark.parametrize("seed,pose", CASES)
def test_mapping_holds_wide_splats_and_duplicate_rows(seed, pose):
  cfg, leaves, _, _, cams, rcfg = view(seed)
  cam = cams[pose]
  g3d = ts.Gaussians3D(*leaves)
  with torch.no_grad():
    g2d, depths, _ = ts.perspective.project_to_image(g3d, cam, rcfg)
    nd = ts.perspective.ndc_depth(depths, cam.near_plane, cam.far_plane)
    nd = torch.where(depths > 0, nd, 0.0)
    m = stream_map_with_config(g2d, nd, torch.zeros((g2d.shape[0], 3)),
                               SIZE, rcfg)
    num_wide, _, _ = wide_stats(g2d, nd, SIZE, rcfg)
  assert int(m.num_overflow) == 0
  assert int(num_wide) > 0.01 * cfg["splats"]
  assert int((m.dup_pid < m.num_points).sum()) > int(num_wide)
