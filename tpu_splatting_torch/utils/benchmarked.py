"""Benchmark harness (``tpu_splatting/utils/benchmarked.py`` counterpart).

``benchmarked`` times ``f(*args)``: on the card with CUDA events around
``iters`` back-to-back calls after ``warmup`` calls, on the CPU with the
host clock.  The reference runs its loop inside one jitted ``lax.scan``
and perturbs the inputs so XLA cannot hoist the body; eager torch
dispatches every call, so neither carries over.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import tempfile
import time
from typing import Callable

import torch


def _on_cuda(x) -> bool:
  """Whether any tensor in ``x`` (tensors, dataclasses, sequences and
  dicts of them) lies on a CUDA device."""
  if isinstance(x, torch.Tensor):
    return x.is_cuda
  if dataclasses.is_dataclass(x) and not isinstance(x, type):
    return any(_on_cuda(getattr(x, f.name)) for f in dataclasses.fields(x))
  if isinstance(x, dict):
    return any(_on_cuda(v) for v in x.values())
  if isinstance(x, (list, tuple)):
    return any(_on_cuda(v) for v in x)
  return False


def benchmarked(name: str, f: Callable, args, iters: int = 50,
                warmup: int = 2, profile: bool = False) -> float:
  """Time ``f(*args)``; returns milliseconds per iteration.

  ``profile`` first runs the ``iters`` calls once more under
  ``torch.profiler`` and writes a Chrome trace under the temporary
  directory."""
  cuda = _on_cuda(args)
  for _ in range(warmup):
    f(*args)
  if cuda:
    torch.cuda.synchronize()

  if profile:
    from torch.profiler import ProfilerActivity
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    with torch.profiler.profile(activities=activities) as prof:
      for _ in range(iters):
        f(*args)
      if cuda:
        torch.cuda.synchronize()
    out_dir = os.path.join(tempfile.gettempdir(), "tpu_splatting_torch_trace")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.json")
    prof.export_chrome_trace(path)
    print(f"{name}: profile trace written to {path}", file=sys.stderr)

  if cuda:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
      f(*args)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / iters
  else:
    t0 = time.perf_counter()
    for _ in range(iters):
      f(*args)
    ms = (time.perf_counter() - t0) / iters * 1000.0
  print(f"{name}: {ms:.3f} ms/iter  ({1000.0 / ms:.1f} it/s)",
        file=sys.stderr)
  return ms
