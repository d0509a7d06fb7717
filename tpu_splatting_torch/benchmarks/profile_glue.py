"""The loss's forward, the pullback and the full gradient: the
counterpart of ``benchmarks/profile_glue.py``.

    python -m tpu_splatting_torch.benchmarks.profile_glue [--device cuda|cpu]
        [--gw 2] [--iters 3] [--n N] [--size W H]

The bench's uniform scene, mapped at group width ``--gw`` with the
trainer's configuration (visibility and point heuristics), and the bench's
tiled loss (``bench.loss_target``).  The reference bisected the gap
between the sum of the stages and the whole XLA graph: the loss's forward
alone, the gradient of the features alone (the same backward kernel and
reduce, the other columns dropped), and the full gradient.  The H100
question: what does each cost when eager torch runs the same kernels (K1,
then K2 and stage 2), and what do the autograd glue and the loss add?
"""

from __future__ import annotations

import sys

import torch

from .. import bench
from ..rasterizer.stream_function import (probe_width,
                                          stream_rasterize_with_mapping)
from . import diagnostics as dg


def loss_of(it, tgt, mask):
  """The bench's tiled loss: sum(mask * (image - tgt)^2) + sum(mask *
  weight)."""
  err = it[:, :-1] - tgt
  return (mask * (err * err)).sum() + (mask[:, 0] * it[:, -1]).sum()


def run(s: bench.SceneSetup, image_size, opts: dg.Opts) -> dict:
  cfg, m = s.config, s.mapping
  p, f = s.raster_args[:2]
  tgt, mask = bench.loss_target(image_size, cfg.tile_size, p.device)
  pw = probe_width(cfg)

  def image(p_, f_, probe):
    return stream_rasterize_with_mapping(p_, f_, m, image_size, cfg,
                                         probe=probe, tiled=True)

  def fwd_loss(p_, f_):
    with torch.no_grad():
      return loss_of(image(p_, f_, p_.new_zeros((p_.shape[0], pw))), tgt,
                     mask)

  def grad_feats(p_, f_):
    f_ = f_.detach().requires_grad_(True)
    probe = p_.new_zeros((p_.shape[0], pw))
    return torch.autograd.grad(loss_of(image(p_, f_, probe), tgt, mask), f_)

  _, fwd_bwd = bench.make_scene_step(image_size, cfg, s.caps)
  return {"fwd+loss": dg.timed("fwd+loss", fwd_loss, (p, f), opts),
          "grad(feats only)": dg.timed("grad(feats only)", grad_feats,
                                       (p, f), opts),
          "full grad": dg.timed("full grad", fwd_bwd, (p, f, tgt, mask, m),
                                opts)}


def main(argv=None) -> int:
  p = dg.parser(__doc__, iters=3)
  dg.scene_options(p, gw=2)
  args = p.parse_args(argv)
  run(dg.prepare("uniform", args, dg.start(args)), tuple(args.size),
      dg.Opts.of(args))
  return 0


if __name__ == "__main__":
  sys.exit(main())
