"""Open loop, one viewer: ``render_gaussians(..., use_sh=True)`` under
``no_grad`` over the seed's poses, the views due at the traffic's fixed
rate, a synchronise after each (``run.window`` times each view from when
it was due).  A sample of views, drawn from the seed, is kept and
compared with the reference's render of the same pose once the window
has closed."""

from __future__ import annotations

import torch

import tpu_splatting_torch as ts

from .. import scenes
from ..reference import steps as ref_steps
from . import common


class Loop:
  kind = "serve"

  def __init__(self, cell, dev, seed, timer):
    self.cfg, self.tr = cell.config, cell.traffic
    self.dev, self.seed, self.timer = dev, seed, timer
    self.size = tuple(self.cfg["image_size"])
    leaves, self.intr, self.poses, self.sample = self.inputs()
    self.g3d = ts.Gaussians3D(*leaves)
    lift = self.cfg["lift"]
    proj = torch.tensor(self.intr, dtype=torch.float32, device=dev)
    self.cams = [ts.CameraParams(projection=proj, T_camera_world=p,
                                 near_plane=lift["near"],
                                 far_plane=lift["far"], image_size=self.size)
                 for p in self.poses]
    self.view_index = 0
    self.kept = {}
    self.rate = self.tr["rate_per_s"]

  def inputs(self):
    """(leaves, intrinsics, poses, the sampled view indices)."""
    draws = scenes.Draws(self.seed, self.dev)
    leaves, intr = common.scene_3d(self.cfg, draws)
    poses = scenes.poses(draws, self.tr["poses"], self.tr["shift"],
                         self.tr["roll_deg"])
    sample = torch.randperm(self.tr["sample_from"], generator=draws.gen,
                            device=self.dev)[:self.tr["check_views"]]
    return leaves, intr, poses, sorted(sample.tolist())

  def calibrate(self):
    """The largest capacities over every pose's calibration."""
    cal = common.calibrate_views(ts, self.g3d, self.cams, self.size,
                                 self.cfg, False)
    self.rcfg = common.raster_config(
        ts.RasterConfig, cal, self.cfg, False)

  def _view(self):
    cam = self.cams[self.view_index % len(self.cams)]
    self.view_index += 1
    with torch.no_grad():
      r = ts.render_gaussians(self.g3d, cam, self.rcfg, use_sh=True)
      bad = (~torch.isfinite(r.image.sum() + r.image_weight.sum())
             | (r.num_overflow != 0))
    self.last = (r.image, r.image_weight)
    return bad

  def op(self):
    return self._view()

  def warm(self):
    """Two views (one builds the kernels; every pose has the same
    shapes); the window's views are numbered from 0 after them.  Then a
    host buffer for each sampled view, pinned on a card, and a stream to
    copy into them."""
    for _ in range(2):
      self._view()
    self.view_index = 0
    pin = self.dev.type == "cuda"
    self.kept = {i: [torch.empty(x.shape, dtype=x.dtype, pin_memory=pin)
                     for x in self.last] for i in self.sample}
    self.copier = torch.cuda.Stream(self.dev) if pin else None
    self.copied = set()

  def keep(self, i):
    """Copy view i's image and weight to its host buffer if it is
    sampled, on the copy stream (called after the view's synchronise:
    nothing waits for the copy, and nothing of it stays on the card)."""
    if i not in self.kept:
      return
    if self.copier is None:
      for buf, x in zip(self.kept[i], self.last):
        buf.copy_(x)
    else:
      with torch.cuda.stream(self.copier):
        for buf, x in zip(self.kept[i], self.last):
          buf.copy_(x, non_blocking=True)
          x.record_stream(self.copier)
    self.copied.add(i)

  def free(self):
    """Wait for the copies; the kept views as (image, weight) on the
    host."""
    if self.copier is not None:
      self.copier.synchronize()
    self.kept = {i: torch.cat([img, weight[..., None]], -1)
                 for i, (img, weight) in self.kept.items()
                 if i in self.copied}
    del self.g3d, self.cams, self.last, self.copier

  def _render(self, i, dtype):
    leaves, intr, poses, _ = self.inputs()
    lift = self.cfg["lift"]
    res = ref_steps.render3d(leaves, intr, poses[i % len(poses)], self.size,
                             lift["near"], lift["far"], dtype=dtype,
                             budget=self.cfg["reference_block"])[0]
    return scenes.detile(res.image.float(), self.size,
                         self.cfg["tile_size"]).cpu()

  def check(self):
    """{"image": the worst sampled view's |program - reference| /
    |reference| over image and weight}; a sampled view that the window
    never finished reads inf."""
    if any(i not in self.kept for i in self.sample):
      return {"image": float("inf")}
    return {"image": max(_rel(self.kept[i], self._render(i, torch.float32))
                         for i in self.sample)}

  def control(self):
    """The same with the reference in bfloat16 in the program's place."""
    return {"image": max(_rel(self._render(i, torch.bfloat16),
                              self._render(i, torch.float32))
                         for i in self.sample)}

  def work(self):
    leaves, intr, poses, _ = self.inputs()
    return common.work_3d(self.cfg, leaves, intr, poses, False)


def _rel(got, want) -> float:
  return common.gap(float(common.norm(got - want)), 0.0,
                    float(common.norm(want)))
