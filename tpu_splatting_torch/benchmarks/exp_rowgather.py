"""Wide-row gathers: the counterpart of ``benchmarks/exp_rowgather.py``.

    python -m tpu_splatting_torch.benchmarks.exp_rowgather [--device cuda|cpu]
        [--iters 5] [--scale 1.0]

The reference asked whether an XLA row gather over the packed (N/rpb,
128) table moves whole 128-lane rows near the TPU's bandwidth, which
would let one map-time gather replace the stream kernels' window copies.
The H100 question: at the same shapes (a packed table of 128 floats, the
unpacked width 32, the heavy scene's scale, a row-major (N, 16) table,
and mostly sequential indices), how fast does torch indexing move wide
rows, and how does the port's ``layout.row_gather`` probe (one thread a
row, 0 outside the table) compare?  Each label's line times torch
indexing (``table[idx]``); the next line gives its useful bytes a second
and ``row_gather``'s time on the same inputs, held bit for bit against
the indexing.  ``--scale`` shrinks every table and index count.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..rasterizer.layout import row_gather
from . import diagnostics as dg

# (table rows, gathered rows, columns): the reference's
SHAPES = ((500_000, 1_600_000, 128), (500_000, 1_600_000, 32),
          (1_000_000, 6_000_000, 128), (2_000_000, 2_000_000, 16))


def gather_pair(label, table, idx, opts: dg.Opts) -> dict:
  """Indexing and ``row_gather`` on the same inputs, held bit for bit."""
  if not torch.equal(row_gather(table, idx), table[idx]):
    raise RuntimeError(f"{label}: row_gather differs from indexing")
  t = dg.timed(label, lambda x, i: x[i], (table, idx), opts)
  r = dg.timed(f"{label} row_gather", row_gather, (table, idx), opts)
  if t.device_ms is not None:     # a rate of the card, not of the CPU
    gb = idx.numel() * table.shape[1] * 4 / 1e9
    print(f"  -> {gb / (t.ms / 1e3):.1f} GB/s useful by indexing, "
          f"{gb / (r.ms / 1e3):.1f} by row_gather", flush=True)
  return {"indexing": t, "row_gather": r}


def run(dev, scale: float, opts: dg.Opts) -> dict:
  rng = np.random.default_rng(0)
  out = {}
  for n, a, cols in SHAPES:
    n, a = max(1, int(n * scale)), max(1, int(a * scale))
    table = torch.from_numpy(rng.random((n, cols), np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, n, a).astype(np.int32)).to(dev)
    label = f"row_gather n={n} a={a} cols={cols}"
    out[label] = gather_pair(label, table, idx.long(), opts)
  n, a, cols = SHAPES[0]
  n, a = max(64, int(n * scale)), max(32, int(a * scale))
  table = torch.from_numpy(rng.random((n, cols), np.float32)).to(dev)
  base = np.sort(rng.integers(0, n - 64, max(1, a // 32)))
  idx = np.clip((base[:, None] + np.arange(32)[None, :] * 2).reshape(-1), 0,
                n - 1)
  label = f"row_gather seq-ish n={n} a={idx.size} cols={cols}"
  out[label] = gather_pair(label, table, torch.from_numpy(idx).to(dev),
                           opts)
  return out


def main(argv=None) -> int:
  p = dg.parser(__doc__, iters=5)
  p.add_argument("--scale", type=float, default=1.0,
                 help="every table and index count times this")
  args = p.parse_args(argv)
  run(dg.start(args), args.scale, dg.Opts.of(args))
  return 0


if __name__ == "__main__":
  sys.exit(main())
