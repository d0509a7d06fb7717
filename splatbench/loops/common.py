"""What the loops share: the program's config from a calibration, the
scene of a configuration, the norm gaps the checks compare."""

from __future__ import annotations

import dataclasses
import statistics

import torch

from .. import roofline, scenes
from ..reference.project import ndc, project
from ..reference.raster import count_pairs, grid
from ..reference.steps import RENDER

# stream_map's capacities, as calibrate_stream names them
MAP_KEYS = ("num_slabs", "strip_cap", "slab_cap", "w_max", "run_cap",
            "wide_cap", "dup_cap")


def max_calibration(cals):
  """The largest of each capacity over the calibrations."""
  return {k: max(int(c[k]) for c in cals)
          for k in MAP_KEYS + ("big_tile_window",)}


def raster_config(raster_config_type, cal, cfg: dict, heuristics: bool):
  """The program's RasterConfig with the calibrated capacities as its
  knobs."""
  base = raster_config_type(
      tile_size=cfg["tile_size"], pipeline=cfg["pipeline"],
      stream_group_width=cfg["group_width"],
      compute_point_heuristic=heuristics, compute_visibility=heuristics)
  if cal is None:
    return base
  return dataclasses.replace(
      base, stream_num_slabs=cal["num_slabs"],
      stream_strip_cap=cal["strip_cap"], stream_slab_cap=cal["slab_cap"],
      stream_w_max=cal["w_max"], stream_run_cap=cal["run_cap"],
      stream_wide_cap=cal["wide_cap"], stream_dup_cap=cal["dup_cap"],
      big_tile_window=cal["big_tile_window"])


def calibrate_views(ts, g3d, cams, image_size, cfg: dict, heuristics: bool):
  """The largest capacities over every camera's calibration, the splats
  projected by the program."""
  probe = raster_config(ts.RasterConfig, None, cfg, heuristics)
  cals = []
  with torch.no_grad():
    for cam in cams:
      g2d, depths, _ = ts.perspective.project_to_image(g3d, cam, probe)
      nd = ts.perspective.ndc_depth(depths, cam.near_plane, cam.far_plane)
      cals.append(ts.calibrate_stream(
          g2d, torch.where(depths > 0, nd, 0.0), g3d.feature[:, :, 0],
          image_size, probe, group_width=cfg["group_width"]))
  return max_calibration(cals)


def scene_2d(cfg: dict, draws):
  """The configuration's 2D scene: (packed, NDC depth, colours)."""
  gen = {"uniform": scenes.uniform_scene,
         "heavy": scenes.heavy_scene}[cfg["scene"]]
  return gen(draws, cfg["splats"], tuple(cfg["image_size"]))


def scene_3d(cfg: dict, draws):
  """The configuration's 2D scene lifted to 3D: (five leaves,
  intrinsics)."""
  packed, depth, feats = scene_2d(cfg, draws)
  lift = cfg["lift"]
  return scenes.lift_to_3d(draws, packed, depth, feats,
                           tuple(cfg["image_size"]), lift["near"],
                           lift["far"], lift["fov_deg"])


def work_3d(cfg: dict, leaves, intr, poses, train: bool) -> dict:
  """The per-layer readers' counts of a 3D cell: the mean (splat, tile)
  pairs over the poses by the harness's own projection and listing, and
  the operations of one step (``train``) or view."""
  size, lift = tuple(cfg["image_size"]), cfg["lift"]
  pairs = []
  with torch.no_grad():
    for pose in poses:
      packed, depth = project(*leaves[:4], pose, intr, size, lift["near"],
                              lift["far"], RENDER)
      pairs.append(count_pairs(packed, ndc(depth, lift["near"], lift["far"]),
                               size, RENDER["alpha_threshold"]))
  tw, th = grid(size)
  p = sum(pairs) / len(pairs)
  return {"pairs": p, "tiles": tw * th, "features": 3,
          "ops": roofline.step_ops(p, 3, cfg["splats"], train, True, True)}


def norm(x) -> torch.Tensor:
  return torch.linalg.vector_norm(x.double())


def gap(program: float, reference: float, scale: float) -> float:
  """|program - reference| / scale (inf where scale is 0)."""
  diff = abs(program - reference)
  return diff / scale if scale > 0 else (0.0 if diff == 0 else float("inf"))


def readings(ref: dict) -> dict:
  """A reference's training run as the norms a program's run records."""
  grads = ref["grads"]
  return {"loss": ref["loss"],
          "grads": [float(norm(g)) for g in grads],
          "heuristics": [float(norm(h)) for h in ref["heuristics"]],
          "m1": float(norm(ref["m1"])), "change": ref["change"]}


def training_numbers(got: dict, want: dict) -> dict:
  """The numbers a training cell compares, each a gap between two
  readings (``readings``' form) against the reference's: the loss of every
  checked step, the worst leaf's gradient norm at step 1 (against the
  larger of the leaf's and the median leaf's reference norm), the worst
  heuristic's norm, the optimizer's first moment after step 1 (the
  gradient as the optimizer got it) and the norm of the trained leaf's
  change after the checked steps."""
  median = statistics.median(want["grads"])
  return {
      "loss": max(gap(p, r, abs(r)) for p, r in zip(got["loss"],
                                                     want["loss"])),
      "grad": max(gap(p, r, max(r, median))
                  for p, r in zip(got["grads"], want["grads"])),
      "heuristics": max(gap(p, r, r) for p, r in zip(got["heuristics"],
                                                     want["heuristics"])),
      "optimizer": gap(got["m1"], want["m1"], want["m1"]),
      "change": gap(got["change"], want["change"], want["change"]),
  }
