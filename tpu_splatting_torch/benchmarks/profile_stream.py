"""The stream pipeline stage by stage: the counterpart of
``benchmarks/profile_stream.py``.

    python -m tpu_splatting_torch.benchmarks.profile_stream [--device cuda|cpu]
        [--gw 2] [--heur] [--iters 3] [--stages map,fwd,bwd,reduce,full]
        [--n N] [--size W H]

The bench's uniform scene calibrated at group width ``--gw`` (the bench's
cache), then each stage alone: ``stream_map``, the forward (K1), the
backward of a ones cotangent (K2 with the slab merge fused into it), the
reduce (``stream_reduce``: stage 2) and the full forward + backward of the
tiled loss, in the plain configuration or, with ``--heur``, the
trainer's (visibility and point heuristics).  The H100 question is the
reference's: which stage of the hot path holds the time?  The shared
assembly variants (``asm``: ``fwd+asm_out``, ``bwd_from_asm``) are a TPU
residual the port does not have; their lines say so.  ``stream_passes``
(split-bf16 passes) is another, so there is no ``--passes``.
"""

from __future__ import annotations

import dataclasses
import sys

import torch

from .. import bench
from ..rasterizer import stream_kernels as sk
from ..rasterizer.stream import stream_map
from ..rasterizer.stream_function import stream_reduce
from . import diagnostics as dg

ASM = ("fwd+asm_out", "bwd_from_asm")


def run(s: bench.SceneSetup, image_size, heur: bool, stages,
        opts: dg.Opts) -> dict:
  cfg = dataclasses.replace(s.config, compute_point_heuristic=heur,
                            compute_visibility=heur)
  m, out = s.mapping, {}
  if "map" in stages:
    out["map"] = dg.timed("map", lambda p, d, f: stream_map(
        p, d, f, image_size, cfg, **s.caps), s.map_args, opts)
  img = sk.stream_forward(m, cfg)
  if "fwd" in stages:
    out["fwd"] = dg.timed("fwd", lambda mm: sk.stream_forward(mm, cfg), (m,),
                          opts)
  gimg = torch.ones_like(img)
  gout = sk.stream_backward(m, img, gimg, cfg)
  if "bwd" in stages:
    out["bwd"] = dg.timed("bwd", lambda mm, i, g: sk.stream_backward(
        mm, i, g, cfg), (m, img, gimg), opts)
  for label in ASM:
    dg.restated(label, "shared assembly (stream_share_asm) is a TPU "
                "residual the port does not have; K1 and K2 each read "
                "the table themselves (fwd, bwd)")
  if "reduce" in stages:
    out["reduce"] = dg.timed("reduce", stream_reduce, (gout, m), opts)
  if "full" in stages:
    _, fwd_bwd = bench.make_scene_step(image_size, cfg, s.caps)
    tgt, mask = bench.loss_target(image_size, cfg.tile_size, img.device)
    out["full fwd+bwd"] = dg.timed("full fwd+bwd", fwd_bwd,
                                   (s.raster_args[0], s.raster_args[1], tgt,
                                    mask, m), opts)
  return out


def main(argv=None) -> int:
  p = dg.parser(__doc__, iters=3)
  dg.scene_options(p, gw=2)
  p.add_argument("--heur", action="store_true",
                 help="trainer config (visibility + point heuristics)")
  p.add_argument("--stages", default="map,fwd,bwd,reduce,full")
  args = p.parse_args(argv)
  s = dg.prepare("uniform", args, dg.start(args))
  run(s, tuple(args.size), args.heur, set(args.stages.split(",")),
      dg.Opts.of(args))
  return 0


if __name__ == "__main__":
  sys.exit(main())
