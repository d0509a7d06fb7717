"""Narrow and lane-dense tensors: the counterpart of
``benchmarks/exp_layout.py``.

    python -m tpu_splatting_torch.benchmarks.exp_layout [--device cuda|cpu]
        [--n 2000000] [--iters 20]

The reference measured what narrow and ragged f32 arrays ((N, 3), (N, 4),
(N, 7), (N, 3, 16)) cost to read, and to read and write, through a jit
boundary on the TPU, whose (8, 128) tiling pads the last dimension,
against lane-dense ones ((N,), (N, 48), (N/4, 128)), then a 3x3 product
against its scalar expansion and the SH contraction as an einsum against
48 columns.  The H100 question: does a narrow last dimension cost
anything through torch ops on this card (no tiling pads it), and do the
projection's small products and the SH contraction prefer one form?
Each workload is sum(x * 1.0001) (one read, a scalar out) or x * 1.0001
(read and write), as the reference's.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from . import diagnostics as dg


def shapes(n):
  return [("(N,)", (n,)), ("(N,3)", (n, 3)), ("(N,4)", (n, 4)),
          ("(N,7)", (n, 7)), ("(N,48)", (n, 48)), ("(N,3,16)", (n, 3, 16)),
          ("(3,N)", (3, n)), ("(N/4,128)", (n // 4, 128))]


def run(n, dev, opts: dg.Opts) -> dict:
  rng = np.random.default_rng(0)

  def tensor(shape):
    return torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dev)

  out = {}
  for name, shp in shapes(n):
    x = tensor(shp)
    r = out[f"read  {name}"] = dg.timed(
        f"read  {name}", lambda a: (a * 1.0001).sum(), (x,), opts)
    rw = out[f"r+w   {name}"] = dg.timed(
        f"r+w   {name}", lambda a: a * 1.0001, (x,), opts)
    if r.device_ms is not None:      # a rate of the card, not of the CPU
      mb = x.numel() * 4 / 1e6
      print(f"#  {name}: logical {mb:.0f} MB -> read {r.ms:.3f} ms "
            f"({mb / r.ms:.0f} GB/s logical), r+w {rw.ms:.3f} ms",
            flush=True)
  rm, x3 = tensor((3, 3)), tensor((n, 3))

  def dot(x):
    return ((x @ rm.T) * 1.0001).sum()

  def expanded(x):
    c0, c1, c2 = x[:, 0], x[:, 1], x[:, 2]
    o0 = c0 * rm[0, 0] + c1 * rm[0, 1] + c2 * rm[0, 2]
    o1 = c0 * rm[1, 0] + c1 * rm[1, 1] + c2 * rm[1, 2]
    o2 = c0 * rm[2, 0] + c1 * rm[2, 1] + c2 * rm[2, 2]
    return (o0 * 1.0001).sum() + o1.sum() + o2.sum()

  out["dot (N,3)@(3,3)"] = dg.timed("dot (N,3)@(3,3)", dot, (x3,), opts)
  out["scalar-expanded"] = dg.timed("scalar-expanded", expanded, (x3,), opts)
  sh3, basis = tensor((n, 3, 16)), tensor((n, 16))

  def ein(sh, b):
    return (torch.einsum("nkb,nb->nk", sh, b) * 1.0001).sum()

  def cols(sh, b):
    acc = 0.0
    for k in range(3):
      s = sum(sh[:, k * 16 + j] * b[:, j] for j in range(16))
      acc = acc + (s * 1.0001).sum()
    return acc

  out["sh einsum (N,3,16)"] = dg.timed("sh einsum (N,3,16)", ein,
                                       (sh3, basis), opts)
  out["sh columns (N,48)"] = dg.timed("sh columns (N,48)", cols,
                                      (sh3.reshape(n, 48), basis), opts)
  return out


def main(argv=None) -> int:
  p = dg.parser(__doc__, iters=20)
  p.add_argument("--n", type=int, default=2_000_000)
  args = p.parse_args(argv)
  run(args.n, dg.start(args), dg.Opts.of(args))
  return 0


if __name__ == "__main__":
  sys.exit(main())
