"""The full-renderer step by stage: the counterpart of
``benchmarks/profile_full.py``.

    python -m tpu_splatting_torch.benchmarks.profile_full [--device cuda|cpu]
        [--gw 2] [--iters 3] [--n N] [--size W H]

The bench's uniform scene lifted to 3D, SH degree 3, calibrated on its
projected splats (``bench.prepare_full``, through the bench's cache), and
the bench's full step (``render_with_heuristics(..., use_sh=True,
tiled=True)``).  The reference timed projection + SH forward, their
forward + backward, the render forward and the full step; its docstring
also names the map and the raster's forward + backward, which are timed
here too (``stream_map_with_config`` on the projected splats, and the
bench's 2D-protocol step on them).  The H100 question: where do the full
step's ~42 ms go?  So one more line splits one step by stage with CUDA
events set by wrappers around the renderer's map and raster calls and by
gradient hooks: projection + SH + ndc, map, raster forward (K1), loss,
raster backward (K2 and the reduce), and the autograd tail: the SH
backward and the projection backward, in the order autograd runs them.
An event stage also holds the device's waits for the host.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time

import torch

from .. import bench, renderer
from ..perspective.projection import ndc_depth, project_to_image
from ..rasterizer.stream_function import stream_map_with_config
from ..spherical_harmonics import evaluate_sh_at
from . import diagnostics as dg

STEP_STAGES = ("projection + SH + ndc", "map", "raster forward (K1)", "loss",
               "raster backward (K2, reduce)", "SH backward",
               "projection backward")


class Marks:
  """Stage boundaries of one pass, each mark opening the stage it names:
  CUDA events on the card (a stage then also holds the device's waits
  for the host), the host clock on the CPU."""

  def __init__(self, dev: torch.device):
    self.cuda, self.points = dev.type == "cuda", []

  def mark(self, stage: str = ""):
    if self.cuda:
      ev = torch.cuda.Event(enable_timing=True)
      ev.record()
      self.points.append((stage, ev))
    else:
      self.points.append((stage, time.perf_counter()))

  def stages(self) -> list:
    """[(stage, ms)] between consecutive marks."""
    if self.cuda:
      torch.cuda.synchronize()
    return [(a[0], a[1].elapsed_time(b[1]) if self.cuda
             else (b[1] - a[1]) * 1e3)
            for a, b in zip(self.points, self.points[1:])]

  def line(self, label: str) -> str:
    clock = "CUDA events" if self.cuda else "host clock, cpu twins"
    return f"{label} ({clock}): " + ", ".join(
        f"{n} {t:.3f} ms" for n, t in self.stages())


@contextlib.contextmanager
def staged(marks: Marks):
  """While open, the renderer's map and raster calls mark where their
  stages start: the map's start and end, the raster forward's end, where
  the backward reaches the raster's output, and where it reaches the
  raster's splats (the projection backward follows) and its SH colours
  (the SH backward follows)."""
  mapper, raster = (renderer.stream_map_with_config,
                    renderer.stream_rasterize_with_mapping)

  def map_call(*a, **k):
    marks.mark("map")
    out = mapper(*a, **k)
    marks.mark("raster forward (K1)")
    return out

  def raster_call(g2d, feats, *a, **k):
    out = raster(g2d, feats, *a, **k)
    marks.mark("loss")
    if out.requires_grad:
      out.register_hook(lambda g: marks.mark("raster backward (K2, reduce)"))
      g2d.register_hook(lambda g: marks.mark("projection backward"))
      feats.register_hook(lambda g: marks.mark("SH backward"))
    return out

  renderer.stream_map_with_config = map_call
  renderer.stream_rasterize_with_mapping = raster_call
  try:
    yield
  finally:
    renderer.stream_map_with_config = mapper
    renderer.stream_rasterize_with_mapping = raster


def step_by_stage(step, g3d, dev) -> dict:
  """One full step split by stage: {stage: ms}."""
  marks = Marks(dev)
  with staged(marks):
    marks.mark("projection + SH + ndc")
    step(g3d)
    marks.mark()
  stages = marks.stages()
  if sorted(n for n, _ in stages) != sorted(STEP_STAGES):
    raise RuntimeError(f"stages {[n for n, _ in stages]}, expected "
                       f"{STEP_STAGES}")
  print(marks.line("full step by stage"), flush=True)
  return dict(stages)


def run(step, g3d, cam, cfg, image_size, opts: dg.Opts) -> dict:
  dg.check_overflow("full step", step(g3d)[3])
  dev = g3d.position.device

  def proj_sh(g):
    g2, d, iv = project_to_image(g, cam, cfg)
    return g2, d, iv, evaluate_sh_at(g.feature, g.position.detach(),
                                     cam.camera_position)

  def proj_sh_grad(g):
    leaves = [getattr(g, k.name).detach().requires_grad_(True)
              for k in dataclasses.fields(g)]
    g = type(g)(*leaves)
    g2, d, _, f = proj_sh(g)
    loss = (g2 * g2).sum() + (f * f).sum() + d.sum()
    return torch.autograd.grad(loss, leaves, allow_unused=True)

  with torch.no_grad():
    g2, d, _, f = proj_sh(g3d)
    nd = torch.where(d > 0, ndc_depth(d, cam.near_plane, cam.far_plane),
                     0.0).reshape(-1)
  map_f = lambda p, d_, f_: stream_map_with_config(p, d_, f_, image_size,
                                                   cfg)
  m = map_f(g2, nd, f)
  dg.check_overflow("map", m.overflow)
  caps = dict(num_slabs=m.num_slabs, strip_cap=m.strip_cap,
              slab_cap=m.slab_cap, w_max=m.w_max, run_cap=m.run_cap,
              wide_cap=cfg.stream_wide_cap, dup_cap=m.dup_cap,
              group_width=m.group_width)
  _, fwd_bwd = bench.make_scene_step(image_size, cfg, caps)
  tgt, mask = bench.loss_target(image_size, cfg.tile_size, dev)
  out = {"proj+sh fwd": dg.timed("proj+sh fwd", proj_sh, (g3d,), opts)}
  out["proj+sh fwd+bwd"] = dg.timed("proj+sh fwd+bwd", proj_sh_grad, (g3d,),
                                    opts)
  out["map"] = dg.timed("map", map_f, (g2, nd, f), opts)
  out["raster fwd+bwd"] = dg.timed("raster fwd+bwd", fwd_bwd,
                                   (g2, f, tgt, mask, m), opts)
  with torch.no_grad():
    out["render fwd"] = dg.timed(
        "render fwd", lambda g: renderer.render_gaussians(
            g, cam, cfg, use_sh=True).image, (g3d,), opts)
  out["full step"] = dg.timed("full step", step, (g3d,), opts)
  out["full step by stage"] = step_by_stage(step, g3d, dev)
  return out


def main(argv=None) -> int:
  p = dg.parser(__doc__, iters=3)
  dg.scene_options(p, gw=2)
  args = p.parse_args(argv)
  dev = dg.start(args)
  size = tuple(args.size)
  step, g3d, cam, cfg = bench.prepare_full(
      "uniform", *bench.scene_arrays("uniform", args.n, size), args.gw, size,
      dev)
  run(step, g3d, cam, cfg, size, dg.Opts.of(args))
  return 0


if __name__ == "__main__":
  sys.exit(main())
