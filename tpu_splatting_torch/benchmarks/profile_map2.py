"""``stream_map`` by stage: the counterpart of ``benchmarks/profile_map2.py``.

    python -m tpu_splatting_torch.benchmarks.profile_map2 [--device cuda|cpu]
        [--scene uniform|heavy] [--gw 8] [--iters 3] [--n N] [--size W H]

The reference split the map by the outputs each variant returned: under
``jax.jit`` the outputs kept decide what runs (dead-code elimination).
Eager torch runs every line of ``stream_map`` whatever the caller keeps,
so those variants do not carry over.  The H100 question: which stage of
``stream_map`` (``rasterizer/stream.py``) holds the device time, and how
many times does each stop the host for the device?  One call runs with a
line tracer on ``stream_map``'s frame (``sys.settrace``) inside one
``torch.profiler`` session: where the call enters a stage, the tracer
opens a ``record_function`` range for it, and each CUDA kernel counts in
the stage whose range holds the op that launched it.  Each stage's line
gives its device busy ms, the kernels it launched, the host's time in it
(the tracer's own cost included) and the host syncs it made
(``torch.cuda.set_sync_debug_mode("warn")``: one warning a synchronising
call, counted where the tracer stands).  ``stream.py`` is
not edited for this.  The stages, from the comments and lines that open
them (``STAGE_MARKS``): bounds, wide/dup, rows and sort (with the table),
edge table, strip blocks, descriptors, gradient gather.

Each reference label still has its line: "everything" and "everything,
no table" are timed calls; the others say which stages their outputs
need and the device ms those stages took.  On the CPU the stages are
timed by the host clock (the plain twins' time) and no device number or
sync is given.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import inspect
import sys
import time
import warnings
from typing import Callable, Optional

import torch

from .. import bench
from ..rasterizer import stream
from . import diagnostics as dg

# (stage, the text of the line that opens it in stream_map); the first
# stage also holds the lines above its mark
STAGE_MARKS = (
    ("bounds", "mean, axis, sigma, alpha = g2d.unpack_g2d"),
    ("wide/dup", "# wide splats (reach beyond"),
    ("rows and sort", "pid = iota(n)"),
    ("edge table", "# ---- class/cell edge table"),
    ("strip blocks", "# ---- per-group strip blocks"),
    ("descriptors", "# group chunks bound"),
    ("gradient gather", "# ---- map-time gradient gather"),
)
STAGES = tuple(name for name, _ in STAGE_MARKS)
# the stages each reference variant's outputs need
NEEDS = {
    "desc+overflow only": STAGES[:6],
    "table only": STAGES[:3],
    "grad_src/dup only": STAGES[:4] + STAGES[6:],
    "run_starts only": STAGES[:4],
    "overflow only": STAGES[:6],
}
RANGE = "stream_map stage: "      # the record_function ranges' names


def stage_starts() -> list:
  """The first source line of each stage in ``stream.stream_map``."""
  lines, first = inspect.getsourcelines(stream.stream_map)
  starts = [first]
  for name, mark in STAGE_MARKS[1:]:
    hits = [i for i, text in enumerate(lines) if mark in text]
    if len(hits) != 1:
      raise RuntimeError(f"stage {name}: {len(hits)} lines of stream_map "
                         f"hold {mark!r}")
    starts.append(first + hits[0])
  if starts != sorted(starts):
    raise RuntimeError(f"stage marks out of order: {starts}")
  return starts


@contextlib.contextmanager
def traced(on_stage: Callable[[int], None]):
  """While open, ``on_stage(i)`` runs each time a ``stream_map`` frame
  enters stage i."""
  starts, code = stage_starts(), stream.stream_map.__code__
  current = [None]

  def local(frame, event, arg):
    if event == "line":
      i = bisect.bisect_right(starts, frame.f_lineno) - 1
      if i != current[0]:
        current[0] = i
        on_stage(i)
    return local

  def tracer(frame, event, arg):
    return local if event == "call" and frame.f_code is code else None

  old = sys.gettrace()
  sys.settrace(tracer)
  try:
    yield
  finally:
    sys.settrace(old)


@dataclasses.dataclass
class Stage:
  ms: float                      # device busy (card) or host clock (cpu)
  kernels: Optional[int] = None
  host_ms: Optional[float] = None    # the host's time in the stage (card)
  syncs: Optional[int] = None


def stage_split(call: Callable[[], object], dev: torch.device) -> dict:
  """One ``call()``, which runs ``stream_map`` on ``dev``, split by
  stage: {stage: Stage}, in stage order."""
  if dev.type != "cuda":
    out, clock = {}, []
    with traced(lambda i: clock.append((i, time.perf_counter()))):
      call()
    clock.append((None, time.perf_counter()))
    for (i, t0), (_, t1) in zip(clock, clock[1:]):
      prev = out.get(STAGES[i], Stage(0.0))
      out[STAGES[i]] = Stage(prev.ms + (t1 - t0) * 1e3)
    return out
  return _device_split(call)


def _device_split(call, attempts: int = 5) -> dict:
  """The card's split, from one ``torch.profiler`` session: each stage is
  a ``record_function`` range opened where the call enters it, and each
  CUDA kernel counts in the range its launching op started in (the
  profiler links every kernel to the op that launched it).  A session
  that lost a range is run again, up to ``attempts`` times."""
  for _ in range(attempts):
    out = _one_device_split(call)
    if out is not None:
      return out
  raise RuntimeError(f"the profiler lost stage ranges in {attempts} "
                     "sessions")


def _one_device_split(call) -> Optional[dict]:
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile, record_function
  order, syncs, ranges = [], {}, []

  def on_stage(i):
    if ranges:
      ranges[-1].__exit__(None, None, None)
    ranges.append(record_function(RANGE + STAGES[i]))
    ranges[-1].__enter__()
    order.append(i)

  def on_warning(message, category, filename, lineno, file=None, line=None):
    if order and "synchronizing" in str(message):
      st = STAGES[order[-1]]
      syncs[st] = syncs.get(st, 0) + 1

  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    with warnings.catch_warnings():
      warnings.simplefilter("always")
      warnings.showwarning = on_warning
      torch.cuda.set_sync_debug_mode("warn")
      try:
        with traced(on_stage):
          call()
      finally:
        torch.cuda.set_sync_debug_mode("default")
        if ranges:
          ranges[-1].__exit__(None, None, None)
    torch.cuda.synchronize()
  evs = [e for e in prof.events() if e.device_type == DeviceType.CPU]
  spans = sorted((e.time_range.start, e.time_range.end, e.name[len(RANGE):])
                 for e in evs if e.name.startswith(RANGE))
  if len(spans) != len(order):
    return None
  out = {STAGES[i]: Stage(0.0, 0, 0.0, 0) for i in sorted(set(order))}
  for a, b, name in spans:
    out[name].host_ms += (b - a) / 1e3
  starts = [a for a, _, _ in spans]
  for e in evs:
    if not e.kernels or e.name.startswith(RANGE):
      continue
    i = bisect.bisect_right(starts, e.time_range.start) - 1
    if i < 0 or e.time_range.start > spans[i][1]:
      continue                       # launched outside the traced call
    st = out[spans[i][2]]
    st.ms += sum(k.duration for k in e.kernels) / 1e3
    st.kernels += len(e.kernels)
  for name, n in syncs.items():
    out[name].syncs = n
  return out


def split_lines(split: dict, whole_ms: Optional[float]) -> list:
  """The split's lines; ``whole_ms`` the untraced call's device time."""
  lines = []
  for name, s in split.items():
    if s.kernels is None:
      lines.append(f"stage {name}: {s.ms:.3f} ms (host clock, cpu twins)")
    else:
      lines.append(f"stage {name}: device {s.ms:.3f} ms in {s.kernels} "
                   f"kernels, host {s.host_ms:.3f} ms, {s.syncs} host "
                   "syncs")
  total = sum(s.ms for s in split.values())
  if whole_ms is not None:
    lines.append(f"stages sum: {total:.3f} ms of the call's {whole_ms:.3f} "
                 f"ms device time ({total / whole_ms:.1%})")
  return lines


def run(s: bench.SceneSetup, image_size, opts: dg.Opts) -> dict:
  """The reference's labels, then the split: {"everything": Timing,
  "everything, no table": Timing, "split": {stage: Stage}}."""
  kw = {**s.caps}
  call = lambda p, d, f: stream.stream_map(p, d, f, image_size, s.config,
                                           **kw)
  out = {"everything": dg.timed("everything", call, s.map_args, opts)}
  split = stage_split(lambda: call(*s.map_args), s.mapping.table.device)
  out["split"] = split
  for label, needs in NEEDS.items():
    ms = sum(split[n].ms for n in needs if n in split)
    dg.restated(label, "eager torch runs every stage whatever the caller "
                "keeps; the stages these outputs need ("
                + ", ".join(needs) + f") took {ms:.3f} ms of "
                + ("device time" if split[STAGES[0]].kernels is not None
                   else "host time (cpu)"))
  no_table = dict(kw, build_table=False)
  out["everything, no table"] = dg.timed(
      "everything, no table",
      lambda p, d, f: stream.stream_map(p, d, f, image_size, s.config,
                                        **no_table), s.map_args, opts)
  for line in split_lines(split, out["everything"].device_ms):
    print(line, flush=True)
  return out


def main(argv=None) -> int:
  p = dg.parser(__doc__, iters=3)
  dg.scene_options(p, gw=8, scene="uniform")
  args = p.parse_args(argv)
  run(dg.prepare(args.scene, args, dg.start(args)), tuple(args.size),
      dg.Opts.of(args))
  return 0


if __name__ == "__main__":
  sys.exit(main())
