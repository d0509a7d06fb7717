"""Inside the backward composition: the counterpart of
``benchmarks/profile_glue2.py``.

    python -m tpu_splatting_torch.benchmarks.profile_glue2 [--device cuda|cpu]
        [--which all|v0|v1|v2|v3] [--gw 2] [--iters 3] [--n N] [--size W H]

Local copies of the stream raster's backward, built from
``stream_kernels`` and ``stream_function`` as the reference built them
from its own, on the bench's uniform scene with the trainer's
configuration:

  v0  K1, then K2 on a constant (ones) cotangent, no reduce;
  v1  K1, then K2 on the real cotangent of the bench's tiled loss;
  v2  v1 and the reduce (``stream_reduce``): the production path;
  v3  v1 with the reduce replaced by a cheap sum of K2's buffer.

The reference asked what feeding a fused cotangent into the Pallas
kernel (a relayout) and the reduce inside the graph cost.  The H100
question: v1 - v0 is what the cotangent's elementwise kernels cost in
front of K2, v2 - v3 what stage 2 of the reduce costs beside a plain sum.
"""

from __future__ import annotations

import sys

import torch

from .. import bench
from ..rasterizer import stream_kernels as sk
from ..rasterizer.stream_function import stream_reduce
from . import diagnostics as dg


def cotangent(img, tgt, mask):
  """d/d image of sum(mask * (rgb - tgt)^2) + sum(mask * weight)."""
  err = img[:, :-1] - tgt
  return torch.cat([2.0 * mask * err, mask.expand_as(img[:, -1:])], 1)


def v0(mapping, cfg, tgt, mask):
  img = sk.stream_forward(mapping, cfg)
  gout = sk.stream_backward(mapping, img, torch.ones_like(img), cfg)
  return gout[:, :8].sum()


def v1(mapping, cfg, tgt, mask):
  img = sk.stream_forward(mapping, cfg)
  gout = sk.stream_backward(mapping, img, cotangent(img, tgt, mask), cfg)
  return gout[:, :8].sum()


def v2(mapping, cfg, tgt, mask):
  img = sk.stream_forward(mapping, cfg)
  gout = sk.stream_backward(mapping, img, cotangent(img, tgt, mask), cfg)
  return stream_reduce(gout, mapping)


def v3(mapping, cfg, tgt, mask):
  img = sk.stream_forward(mapping, cfg)
  gout = sk.stream_backward(mapping, img, cotangent(img, tgt, mask), cfg)
  return gout.sum(0)


VARIANTS = (("v0", "v0 const-cotangent fwd+bwd", v0),
            ("v1", "v1 fused-cotangent fwd+bwd", v1),
            ("v3", "v3 v1+sum(gout)", v3),
            ("v2", "v2 v1+reduce", v2))


def run(s: bench.SceneSetup, image_size, which: str, opts: dg.Opts) -> dict:
  m, cfg = s.mapping, s.config
  tgt, mask = bench.loss_target(image_size, cfg.tile_size,
                                m.table.device)
  return {label: dg.timed(label, fn, (m, cfg, tgt, mask), opts)
          for key, label, fn in VARIANTS if which in (key, "all")}


def main(argv=None) -> int:
  p = dg.parser(__doc__, iters=3)
  dg.scene_options(p, gw=2)
  p.add_argument("--which", default="all",
                 choices=["all"] + [k for k, _, _ in VARIANTS])
  args = p.parse_args(argv)
  run(dg.prepare("uniform", args, dg.start(args)), tuple(args.size),
      args.which, dg.Opts.of(args))
  return 0


if __name__ == "__main__":
  sys.exit(main())
