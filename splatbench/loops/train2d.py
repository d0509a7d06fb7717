"""Closed loop, one trainer on 2D splats, the reference library's
decomposed protocol: ``stream_map``, then ``stream_rasterize_with_mapping``
forward + backward of the tiled loss (masked L2 plus the masked weight)
with a zero probe carrying visibility and the point heuristics, then
``VisibilityAwareAdam`` on the colour features.  It cycles over input
sets, each the scene shifted by a sub-pixel offset from the seed."""

from __future__ import annotations

import torch

import tpu_splatting_torch as ts
from tpu_splatting_torch import optim

from .. import roofline, scenes
from ..reference import steps as ref_steps
from ..reference.raster import count_pairs, grid
from . import common


class Loop:
  kind = "train"

  def __init__(self, cell, dev, seed, timer):
    self.cfg, self.tr = cell.config, cell.traffic
    self.dev, self.seed, self.timer = dev, seed, timer
    self.size = tuple(self.cfg["image_size"])
    self.sets, self.depth, self.feats, self.tgt, self.mask = self.inputs()
    self.step_index = 0

  def inputs(self):
    """(packed input sets, NDC depth, colours, target, mask), the same on
    every call."""
    draws = scenes.Draws(self.seed, self.dev)
    packed, depth, feats = common.scene_2d(self.cfg, draws)
    offsets = scenes.shifts(draws, self.tr["inputs"], self.tr["shift_px"])
    sets = []
    for off in offsets:
      p = packed.clone()
      p[:, :2] += off
      sets.append(p)
    tgt, mask = scenes.target(draws, self.size, self.cfg["tile_size"])
    return sets, depth, feats, tgt, mask

  def calibrate(self):
    """The largest capacities over every input set's calibration."""
    cfg = common.raster_config(ts.RasterConfig, None, self.cfg, True)
    with torch.no_grad():
      cal = common.max_calibration([
          ts.calibrate_stream(p, self.depth, self.feats, self.size, cfg,
                              group_width=self.cfg["group_width"])
          for p in self.sets])
    self.rcfg = common.raster_config(ts.RasterConfig, cal, self.cfg, True)
    self.caps = {k: cal[k] for k in common.MAP_KEYS}
    self.caps["group_width"] = self.cfg["group_width"]
    self.opt = optim.VisibilityAwareAdam(
        {"feature": optim.GroupConfig(lr=self.tr["lr"])})
    self.state = self.opt.init({"feature": self.feats})

  def _step(self):
    packed = self.sets[self.step_index % len(self.sets)]
    self.step_index += 1
    with self.timer.span("map"):
      mapping = ts.stream_map(packed, self.depth, self.feats, self.size,
                              self.rcfg, **self.caps)
    p = packed.detach().requires_grad_(True)
    f = self.feats.detach().requires_grad_(True)
    probe = torch.zeros((p.shape[0], 3), dtype=p.dtype, device=p.device,
                        requires_grad=True)
    it = ts.stream_rasterize_with_mapping(p, f, mapping, self.size,
                                          self.rcfg, probe=probe, tiled=True)
    err = it[:, :-1] - self.tgt
    loss = (self.mask * err * err).sum() + (self.mask[:, 0] * it[:, -1]).sum()
    g_p, g_f, g_probe = torch.autograd.grad(loss, (p, f, probe))
    with self.timer.span("optimizer"):
      params, self.state = self.opt.step(
          {"feature": self.feats}, {"feature": g_f}, self.state,
          g_probe[:, 0])
    self.feats = params["feature"]
    total = loss.detach() + g_p.sum() + g_f.sum() + g_probe.sum()
    bad = ~torch.isfinite(total) | (mapping.num_overflow != 0)
    return bad, loss.detach(), (g_p, g_f), g_probe

  def op(self):
    return self._step()[0]

  def warm(self):
    """The checked steps, recorded as norms (see train3d)."""
    start = self.feats
    losses = []
    for i in range(self.tr["check_steps"]):
      _, loss, grads, g_probe = self._step()
      losses.append(loss)
      if i == 0:
        first = [common.norm(g) for g in grads]
        heur = [common.norm(g_probe[:, c]) for c in range(3)]
        m1 = common.norm(self.state.groups["feature"]["m"])
    change = common.norm(self.feats - start)
    self.recorded = torch.stack([x.double() for x in losses] + first + heur
                                + [m1, change])

  def free(self):
    got = self.recorded.tolist()
    k = self.tr["check_steps"]
    self.got = {"loss": got[:k], "grads": got[k:k + 2],
                "heuristics": got[k + 2:k + 5], "m1": got[k + 5],
                "change": got[k + 6]}
    del self.sets, self.feats, self.state, self.opt, self.recorded

  def reference(self, dtype=torch.float32):
    sets, depth, feats, tgt, mask = self.inputs()
    k = self.tr["check_steps"]
    ref = ref_steps.train2d(sets[:k], depth, feats, self.size, tgt, mask,
                            self.tr["lr"], dtype=dtype,
                            budget=self.cfg["reference_block"])
    ref["change"] = float(common.norm(ref["feature"].float() - feats))
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
    sets, depth, _, _, _ = self.inputs()
    pairs = [count_pairs(p, depth, self.size,
                         ref_steps.RENDER["alpha_threshold"]) for p in sets]
    tw, th = grid(self.size)
    p = sum(pairs) / len(pairs)
    return {"pairs": p, "tiles": tw * th, "features": 3,
            "ops": roofline.step_ops(p, 3, self.cfg["splats"], True, False,
                                     False)}
