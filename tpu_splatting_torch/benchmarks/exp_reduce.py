"""The backward reduce's glue: the counterpart of ``benchmarks/exp_reduce.py``.

    python -m tpu_splatting_torch.benchmarks.exp_reduce [--device cuda|cpu]
        [--a 4400000] [--n 1000000] [--c 12] [--iters 10]

``--a`` gradient rows of ``--c`` f32 columns summed into ``--n`` points:
the sorted pipeline's reduce (``function.reduce_chunked_to_points``: one
stable ``torch.sort`` of the point ids, then K7,
``layout.segment_sum_sorted``, reading the rows through the sort's order)
and the pieces the reference isolated: column extraction, the sort
carrying the matrix or its split columns, stacking, the TPU's packing
into super-rows, K7 alone, the chain with a sorted copy, and bf16
columns packed in pairs.  The reference asked where ~85 ms of glue around
its sort and segment sum went.  The H100 question: what does each piece
of the port's reduce (sort, gather, K7) cost, and what would a sorted
copy, the TPU's packing or bf16 columns add or save?  K7 has no block
size, so the reference's four ``segsum_b*`` lines each time K7 at one
width, C 1, 6, 12 and 21 (the sorted step's visibility, a gradient of 6
columns, its 12 and one of 21).  The bf16 lines are measured only: the
port's reduce stays f32.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..rasterizer.function import reduce_chunked_to_points, sort_point_ids
from ..rasterizer.layout import segment_sum_sorted
from . import diagnostics as dg

SEGSUM_WIDTHS = {128: 1, 256: 6, 512: 12, 1024: 21}


def inputs(a, n, c, dev, dyadic=False, seed=0):
  """(gout (a, c) f32, sorted point ids, unsorted point ids), seeded;
  ``dyadic`` rows are multiples of 1/64 below 4, so every order of
  summation gives the same f32 sums."""
  rng = np.random.default_rng(seed)
  g = rng.standard_normal((a, c))
  if dyadic:
    g = np.round(g * 64) / 64
  pid = np.sort(rng.integers(0, n, a)).astype(np.int32)
  pid_u = rng.integers(0, n, a).astype(np.int32)
  return tuple(torch.from_numpy(x).to(dev) for x in
               (g.astype(np.float32), pid, pid_u))


def gathered(p, *cols):
  """Each column gathered by the stable sort of the ids ``p``."""
  order = torch.sort(p, stable=True).indices
  return [x[order] for x in cols]


def sort_stack(g, pid):
  """The rows in point-id order (a sorted copy) and the sorted ids."""
  o = sort_point_ids(pid)
  return g[o.order], o.ids


def pack(g, ids):
  """The TPU's super-rows: each row widened to 16 lanes (the id's bits
  last), padded past a sentinel block, (M/8, 128)."""
  a, c = g.shape
  idcol = ids.view(torch.float32)[:, None]
  m_pad = ((a + 1023) // 1024 + 1) * 1024
  logical = torch.cat([g, g.new_zeros((a, 16 - 1 - c)), idcol], -1)
  return torch.cat([logical, g.new_zeros((m_pad - a, 16))]).reshape(-1, 128)


def reduce_e2e(g, pid, n):
  """The port's reduce: one sort, then K7 through its order."""
  return reduce_chunked_to_points(g, sort_point_ids(pid), n)


def chain_full(g, pid, n):
  """Sort, a sorted copy, then K7 on it (no order)."""
  rows, ids = sort_stack(g, pid)
  return segment_sum_sorted(rows, ids, n)


def pack_bf16(g):
  """Pairs of bf16 columns as one 32-bit word each."""
  gb = g.to(torch.bfloat16).view(torch.int16).to(torch.int32) & 0xFFFF
  return [(gb[:, i] | (gb[:, i + 1] << 16)).view(torch.float32)
          for i in range(0, g.shape[1] - 1, 2)]


def run(a, n, c, dev, opts: dg.Opts) -> dict:
  g, pid, pid_u = inputs(a, n, c, dev)
  out = {}

  def t(label, fn, args, note=""):
    out[label] = dg.timed(label, fn, args, opts, note)

  t("cols_extract", lambda x: torch.stack([x[:, i].sum() for i in range(c)]),
    (g,))
  t("sort_from_matrix", lambda x, p: gathered(p, x), (g, pid_u),
    "torch.sort of the ids, then the rows gathered by its permutation")
  cols = [g[:, i].contiguous() for i in range(c)]
  t("sort_from_cols", gathered, (pid_u, *cols),
    "the same with each column gathered alone")
  t("stack_cols", lambda *cs: torch.stack(cs, -1), cols)
  t("pack_superrows", pack, (g, pid),
    "a TPU layout: K7 reads (A, C) rows as they are; the copy alone")
  for b, w in SEGSUM_WIDTHS.items():
    gw = g[:, :w].contiguous() if w <= c else g.repeat(1, -(-w // c))[:, :w]
    gw = gw.contiguous()
    t(f"segsum_b{b}", lambda x, p: segment_sum_sorted(x, p, n), (gw, pid),
      f"restated: K7 takes no block size; K7 at C {w}")
  t("reduce_e2e", lambda x, p: reduce_e2e(x, p, n), (g, pid_u))
  t("chain_sort_stack", lambda x, p: sort_stack(x, p)[0], (g, pid_u))
  t("chain_sort_stack_pack", lambda x, p: pack(*sort_stack(x, p)),
    (g, pid_u))
  t("chain_full", lambda x, p: chain_full(x, p, n), (g, pid_u))
  rows_s = sort_stack(g, pid_u)[0]
  t("segsum_again_b512", lambda x, p: segment_sum_sorted(x + 0.0, p, n),
    (rows_s, pid), "K7 on presorted rows, no order")
  packed = pack_bf16(g)
  t("sort_bf16_packed", gathered, (pid_u, *packed),
    "measured only: the port keeps f32")
  t("pack_bf16_cost", lambda x: pack_bf16(x)[0], (g,),
    "measured only: the port keeps f32")
  return out


def main(argv=None) -> int:
  p = dg.parser(__doc__, iters=10)
  p.add_argument("--a", type=int, default=4_400_000)
  p.add_argument("--n", type=int, default=1_000_000)
  p.add_argument("--c", type=int, default=12)
  args = p.parse_args(argv)
  run(args.a, args.n, args.c, dg.start(args), dg.Opts.of(args))
  return 0


if __name__ == "__main__":
  sys.exit(main())
