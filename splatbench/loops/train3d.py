"""Closed loop, one trainer: ``render_with_heuristics(..., use_sh=True,
tiled=True)`` on the masked L2 loss against a seeded target, then
``VisibilityAwareAdam`` on the SH features, cycling over the seed's
poses.  The window drives one trainer object, the one that set-up built
and stepped through the checked steps."""

from __future__ import annotations

import torch

import tpu_splatting_torch as ts
from tpu_splatting_torch import optim

from .. import scenes
from ..reference import steps as ref_steps
from . import common


class Loop:
  kind = "train"

  def __init__(self, cell, dev, seed, timer):
    self.cfg, self.tr = cell.config, cell.traffic
    self.dev, self.seed, self.timer = dev, seed, timer
    self.size = tuple(self.cfg["image_size"])
    leaves, self.intr, self.poses, self.tgt, self.mask = self.inputs()
    self.g3d = ts.Gaussians3D(*leaves)
    lift = self.cfg["lift"]
    proj = torch.tensor(self.intr, dtype=torch.float32, device=dev)
    self.cams = [ts.CameraParams(projection=proj, T_camera_world=p,
                                 near_plane=lift["near"],
                                 far_plane=lift["far"], image_size=self.size)
                 for p in self.poses]
    self.step_index = 0

  def inputs(self):
    """Everything the seed makes: (leaves, intrinsics, poses, target,
    mask), the same on every call."""
    draws = scenes.Draws(self.seed, self.dev)
    leaves, intr = common.scene_3d(self.cfg, draws)
    poses = scenes.poses(draws, self.tr["poses"], self.tr["shift"],
                         self.tr["roll_deg"])
    tgt, mask = scenes.target(draws, self.size, self.cfg["tile_size"])
    return leaves, intr, poses, tgt, mask

  def calibrate(self):
    """The largest capacities over every pose's calibration."""
    cal = common.calibrate_views(ts, self.g3d, self.cams, self.size,
                                 self.cfg, True)
    self.rcfg = common.raster_config(ts.RasterConfig, cal, self.cfg, True)
    self.opt = optim.VisibilityAwareAdam(
        {"feature": optim.GroupConfig(lr=self.tr["lr"])})
    self.state = self.opt.init({"feature": self.g3d.feature})

  def loss_fn(self, rendering):
    err = rendering.image - self.tgt
    return (self.mask * err * err).sum()

  def _step(self):
    cam = self.cams[self.step_index % len(self.cams)]
    self.step_index += 1
    loss, rendering, grads = ts.render_with_heuristics(
        self.loss_fn, self.g3d, cam, self.rcfg, use_sh=True, tiled=True)
    points = rendering.points
    with self.timer.span("optimizer"):
      params, self.state = self.opt.step(
          {"feature": self.g3d.feature}, {"feature": grads.feature},
          self.state, points.visibility)
    self.g3d = self.g3d.replace(feature=params["feature"])
    total = loss + sum(g.sum() for g in (grads.position, grads.log_scaling,
                                         grads.rotation, grads.alpha_logit,
                                         grads.feature))
    bad = ~torch.isfinite(total) | (rendering.num_overflow != 0)
    return bad, loss, grads, points

  def op(self):
    return self._step()[0]

  def warm(self):
    """The checked steps: their losses, step 1's gradient and heuristic
    norms and the optimizer's first moment, the change of the features
    after the last, kept as norms on the device until ``check``."""
    start = self.g3d.feature
    losses = []
    for i in range(self.tr["check_steps"]):
      bad, loss, grads, points = self._step()
      losses.append(loss)
      if i == 0:
        first = [common.norm(g) for g in (
            grads.position, grads.log_scaling, grads.rotation,
            grads.alpha_logit, grads.feature)]
        heur = [common.norm(h) for h in (
            points.visibility, points.prune_cost, points.split_score)]
        m1 = common.norm(self.state.groups["feature"]["m"])
    change = common.norm(self.g3d.feature - start)
    self.recorded = torch.stack([x.double() for x in losses] + first + heur
                                + [m1, change])

  def free(self):
    got = self.recorded.tolist()
    k = self.tr["check_steps"]
    self.got = {"loss": got[:k], "grads": got[k:k + 5],
                "heuristics": got[k + 5:k + 8], "m1": got[k + 8],
                "change": got[k + 9]}
    del self.g3d, self.state, self.opt, self.cams, self.recorded

  def reference(self, dtype=torch.float32):
    leaves, intr, poses, tgt, mask = self.inputs()
    lift = self.cfg["lift"]
    k = self.tr["check_steps"]
    ref = ref_steps.train3d(leaves, intr, poses[:k], self.size, lift["near"],
                            lift["far"], tgt, mask, self.tr["lr"],
                            dtype=dtype, budget=self.cfg["reference_block"])
    ref["change"] = float(common.norm(ref["feature"].float() - leaves[4]))
    return ref

  def check(self):
    return common.training_numbers(
        self.got, common.readings(self.reference()))

  def control(self):
    """The numbers with the reference in bfloat16 in the program's
    place."""
    want = common.readings(self.reference())
    return common.training_numbers(
        common.readings(self.reference(torch.bfloat16)), want)

  def work(self):
    leaves, intr, poses, _, _ = self.inputs()
    return common.work_3d(self.cfg, leaves, intr, poses, True)
