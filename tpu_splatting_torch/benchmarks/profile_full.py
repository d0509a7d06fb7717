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
step's ~42 ms go?  So one more line splits one step by stage with the
program's own spans (``tpu_splatting_torch.trace``, their CUDA events on
the card, the host clock on the CPU): projection + SH (``project`` and
``sh``; the NDC depth is in no span), map, raster forward (``k1``), raster
backward (``backward.raster``: K2 and the reduce), and the autograd tail:
the SH backward and the projection backward (``backward.sh`` and
``backward.project``, opened where autograd reaches each one's gradient).
"loss" is the rest of the step: the loss, the NDC depth and what no span
holds.  A span's events also hold the device's waits for the host.
"""

from __future__ import annotations

import dataclasses
import sys

import torch

from .. import bench, renderer, trace
from ..perspective.projection import ndc_depth, project_to_image
from ..rasterizer.stream_function import stream_map_with_config
from ..spherical_harmonics import evaluate_sh_at
from . import diagnostics as dg

# (stage, the program's spans it sums)
STEP_STAGES = (("projection + SH + ndc", ("project", "sh")),
               ("map", ("map",)),
               ("raster forward (K1)", ("k1",)),
               ("loss", ()),
               ("raster backward (K2, reduce)", ("backward.raster",)),
               ("SH backward", ("backward.sh",)),
               ("projection backward", ("backward.project",)))
WHOLE = "full step by stage"


def step_by_stage(step, g3d, dev) -> dict:
  """One full step split by stage: {stage: ms}."""
  trace.reset()
  trace.enable()
  try:
    with trace.span(WHOLE):
      step(g3d)
  finally:
    trace.disable()
  spans = {k: s["device_ms"] * s["calls"] for k, s in trace.summary().items()}
  trace.reset()
  missing = [k for _, names in STEP_STAGES for k in names if k not in spans]
  if missing:
    raise RuntimeError(f"spans {sorted(spans)}, missing {missing}")
  stages = {stage: sum(spans[k] for k in names)
            for stage, names in STEP_STAGES}
  stages["loss"] = spans[WHOLE] - sum(stages.values())
  clock = "CUDA events" if dev.type == "cuda" else "host clock, cpu twins"
  print(f"{WHOLE} ({clock}): " + ", ".join(
      f"{n} {t:.3f} ms" for n, t in stages.items()), flush=True)
  return stages


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
