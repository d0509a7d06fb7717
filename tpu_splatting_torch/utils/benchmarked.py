"""Benchmark harness (``tpu_splatting/utils/benchmarked.py`` counterpart).

``benchmarked`` times ``f(*args)``: on the card with CUDA events around
``iters`` back-to-back calls after ``warmup`` calls, on the CPU with the
host clock.  The reference runs its loop inside one jitted ``lax.scan``
and perturbs the inputs so XLA cannot hoist the body; eager torch
dispatches every call, so neither carries over.  ``profiled_kernels``
reads the card's own time per CUDA kernel from one ``torch.profiler``
session.
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


# the spin kernels around a profiler session: ~25 us each on an H100
SPIN_CYCLES = 50_000


def profiled_kernels(fn: Callable[[], object], reps: int, host: bool = True):
  """One ``torch.profiler`` session of ``reps`` ``fn()`` calls on the
  card between two spin kernels (``torch.cuda._sleep``): ({CUDA kernel
  name: device us}, {name: records}), the spin kernels left out.  A
  session on a busy card now and then loses the records of its last
  kernels; the spin kernels ended those losses.  ``host=False`` records
  CUDA activity only: a session of thousands of kernels then takes the
  profiler a fraction of the time to read."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  with profile(activities=[ProfilerActivity.CPU] * host +
               [ProfilerActivity.CUDA]) as prof:
    torch.cuda._sleep(SPIN_CYCLES)
    for _ in range(reps):
      fn()
    torch.cuda._sleep(SPIN_CYCLES)
    torch.cuda.synchronize()
  us, count = {}, {}
  for e in prof.events():
    if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.name:
      us[e.name] = us.get(e.name, 0.0) + e.device_time_total
      count[e.name] = count.get(e.name, 0) + 1
  return us, count


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
