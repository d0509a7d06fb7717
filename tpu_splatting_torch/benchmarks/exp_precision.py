"""Matmul precision: the counterpart of ``benchmarks/exp_precision.py``.

    python -m tpu_splatting_torch.benchmarks.exp_precision [--device cuda|cpu]
        [--iters 20] [--n N] [--size W H] [--gw 8]

The reference timed f32 matmuls at the TPU rasterizer's kernel shapes
under ``Precision.DEFAULT``, ``HIGH`` and ``HIGHEST`` (1, 3 and 6 bf16
passes) and in bf16.  Here each of those lines runs the same batched
product (``torch.bmm``) under ``torch.set_float32_matmul_precision``
"medium", "high" and "highest" (on the H100: bf16 or TF32 tensor-core
passes where cuBLAS takes them, TF32, and plain f32), then in bf16.  The
H100 question is the autograd tail's: the full training step spends
about 7 ms in a cuBLAS ``gemmSN_TN`` kernel (``PERF.md`` §5).  So the
matmuls of one bench full step (``bench.prepare_full``) are found with
``torch.profiler`` (``record_shapes``), and the three that take the most
time are timed again at their own shapes in f32 and in TF32, with the
largest difference between the two results.  A measurement only: the
port keeps f32 (``chip_smoke.py`` turns TF32 off), and every setting is
restored on the way out.
"""

from __future__ import annotations

import contextlib
import sys

import numpy as np
import torch

from .. import bench
from . import diagnostics as dg

SHAPES = ((128, 6, 256, 2048), (128, 128, 256, 2048), (512, 1024, 16, 1024))
PRECISIONS = (("DEFAULT", "medium"), ("HIGH", "high"), ("HIGHEST", "highest"))
MATMULS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm")


@contextlib.contextmanager
def precision(p: str):
  """``torch.set_float32_matmul_precision(p)`` while open."""
  old = torch.get_float32_matmul_precision()
  torch.set_float32_matmul_precision(p)
  try:
    yield
  finally:
    torch.set_float32_matmul_precision(old)


def run_shape(m, k, n, reps, dev, opts: dg.Opts) -> dict:
  """The reference's batched product at one shape under each precision,
  then in bf16."""
  rng = np.random.default_rng(0)
  a = torch.from_numpy(rng.standard_normal((reps, m, k), np.float32)).to(dev)
  b = torch.from_numpy(rng.standard_normal((reps, k, n), np.float32)).to(dev)
  f = lambda x, y: torch.bmm(x, y).sum()
  out = {}
  for name, p in PRECISIONS:
    label = f"mm {m}x{k}x{n} float32 {name} x{reps}"
    with precision(p):
      out[label] = dg.timed(label, f, (a, b), opts,
                            f"torch float32 matmul precision {p!r}")
  label = f"mm {m}x{k}x{n} bf16 x{reps}"
  out[label] = dg.timed(label, f, (a.bfloat16(), b.bfloat16()), opts)
  return out


def step_matmuls(step, g3d, dev, top: int = 3) -> list:
  """The ``top`` matmuls of one ``step(g3d)`` by time: [(op, input
  shapes, ms)], device ms on the card, host ms on the CPU."""
  from torch.profiler import ProfilerActivity, profile
  acts = [ProfilerActivity.CPU] + (
      [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
  step(g3d)
  with profile(activities=acts, record_shapes=True) as prof:
    step(g3d)
    if dev.type == "cuda":
      torch.cuda.synchronize()
  found = {}
  for e in prof.events():
    if e.name in MATMULS:
      key = (e.name, tuple(tuple(s) for s in e.input_shapes if s))
      ms = (sum(k.duration for k in e.kernels) if dev.type == "cuda"
            else e.self_cpu_time_total) / 1e3
      found[key] = found.get(key, 0.0) + ms
  return sorted(((op, shp, ms) for (op, shp), ms in found.items()),
                key=lambda x: -x[2])[:top]


def tail_matmuls(step, g3d, dev, opts: dg.Opts) -> list:
  """Each of the step's heaviest matmuls at its own shapes, f32 against
  TF32: [(label, f32 Timing, TF32 Timing, max |TF32 - f32| / max |f32|)]."""
  ops = {"aten::mm": torch.mm, "aten::bmm": torch.bmm,
         "aten::addmm": torch.addmm, "aten::baddbmm": torch.baddbmm}
  rng = np.random.default_rng(1)
  out = []
  for op, shapes, ms in step_matmuls(step, g3d, dev):
    args = tuple(torch.from_numpy(rng.standard_normal(s, np.float32)).to(dev)
                 for s in shapes)
    label = f"step {op} {' x '.join(str(list(s)) for s in shapes)}"
    with precision("highest"):
      ref = ops[op](*args)
      t32 = dg.timed(f"{label} f32", ops[op], args, opts,
                     f"{ms:.3f} ms of the step")
    with precision("high"):
      diff = float((ops[op](*args) - ref).abs().max() / ref.abs().max())
      ttf = dg.timed(f"{label} TF32", ops[op], args, opts,
                     f"max |TF32 - f32| {diff:.3e} of max |f32|")
    out.append((label, t32, ttf, diff))
  return out


def main(argv=None) -> int:
  p = dg.parser(__doc__, iters=20)
  dg.scene_options(p, gw=8)
  p.add_argument("--reps", type=int, default=None,
                 help="the batch of every product (default: the "
                 "reference's, 2048 or 1024)")
  args = p.parse_args(argv)
  dev = dg.start(args)
  opts = dg.Opts.of(args)
  for m, k, n, reps in SHAPES:
    run_shape(m, k, n, args.reps or reps, dev, opts)
  size = tuple(args.size)
  step, g3d, _, _ = bench.prepare_full(
      "uniform", *bench.scene_arrays("uniform", args.n, size), args.gw, size,
      dev)
  tail_matmuls(step, g3d, dev, opts)
  return 0


if __name__ == "__main__":
  sys.exit(main())
