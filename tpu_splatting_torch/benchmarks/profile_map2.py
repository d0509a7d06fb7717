"""``stream_map`` by stage: the counterpart of ``benchmarks/profile_map2.py``.

    python -m tpu_splatting_torch.benchmarks.profile_map2 [--device cuda|cpu]
        [--scene uniform|heavy] [--gw 8] [--iters 3] [--n N] [--size W H]

The reference split the map by the outputs each variant returned: under
``jax.jit`` the outputs kept decide what runs (dead-code elimination).
Eager torch runs every line of ``stream_map`` whatever the caller keeps,
so those variants do not carry over.  The H100 question: which stage of
``stream_map`` (``rasterizer/stream.py``) holds the device time, and how
many times does each stop the host for the device?  One call runs with
the program's tracing on (``tpu_splatting_torch.trace``) inside one
``torch.profiler`` session: ``stream_map`` opens a span for each of its
stages (``map.bounds`` ... ``map.grad_gather``), and each CUDA kernel
counts in the stage whose span holds the op that launched it.  Each
stage's line gives its device busy ms, the kernels it launched, the
host's time in it and the host syncs it made (the spans' own count).
The stages: bounds, wide/dup, rows and sort (with the table), edge table,
strip blocks, descriptors, gradient gather.

Each reference label still has its line: "everything" and "everything,
no table" are timed calls; the others say which stages their outputs
need and the device ms those stages took.  On the CPU the stages are
timed by the host clock (the plain twins' time) and no device number or
sync is given.
"""

from __future__ import annotations

import bisect
import dataclasses
import sys
from typing import Callable, Optional

import torch

from .. import bench, trace
from ..rasterizer import stream
from . import diagnostics as dg

# (stage, the span stream_map opens for it)
STAGE_SPANS = (
    ("bounds", "map.bounds"),
    ("wide/dup", "map.wide_dup"),
    ("rows and sort", "map.sort"),
    ("edge table", "map.edges"),
    ("strip blocks", "map.strips"),
    ("descriptors", "map.descriptors"),
    ("gradient gather", "map.grad_gather"),
)
STAGES = tuple(name for name, _ in STAGE_SPANS)
STAGE_OF = {span: name for name, span in STAGE_SPANS}
# the stages each reference variant's outputs need
NEEDS = {
    "desc+overflow only": STAGES[:6],
    "table only": STAGES[:3],
    "grad_src/dup only": STAGES[:4] + STAGES[6:],
    "run_starts only": STAGES[:4],
    "overflow only": STAGES[:6],
}


@dataclasses.dataclass
class Stage:
  ms: float                      # device busy (card) or host clock (cpu)
  kernels: Optional[int] = None
  host_ms: Optional[float] = None    # the host's time in the stage (card)
  syncs: Optional[int] = None


def traced_call(call: Callable[[], object]) -> dict:
  """``call()`` with the program's tracing on: ``trace.summary()`` of the
  call alone."""
  trace.reset()
  trace.enable()
  try:
    call()
  finally:
    trace.disable()
  out = trace.summary()
  trace.reset()
  return out


def stage_split(call: Callable[[], object], dev: torch.device) -> dict:
  """One ``call()``, which runs ``stream_map`` on ``dev``, split by
  stage: {stage: Stage}, in stage order."""
  if dev.type != "cuda":
    spans = traced_call(call)
    return {STAGE_OF[span]: Stage(s["host_ms"] * s["calls"])
            for span, s in spans.items() if span in STAGE_OF}
  return _device_split(call)


def _device_split(call, attempts: int = 5) -> dict:
  """The card's split, from one ``torch.profiler`` session with tracing
  on: each CUDA kernel counts in the stage span that holds the op that
  launched it (the profiler links every kernel to the op that launched
  it).  A session that lost a span is run again, up to ``attempts``
  times."""
  for _ in range(attempts):
    out = _one_device_split(call)
    if out is not None:
      return out
  raise RuntimeError(f"the profiler lost stage spans in {attempts} "
                     "sessions")


def _one_device_split(call) -> Optional[dict]:
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    summary = traced_call(call)
    torch.cuda.synchronize()
  evs = [e for e in prof.events() if e.device_type == DeviceType.CPU]
  spans = sorted((e.time_range.start, e.time_range.end,
                  STAGE_OF[e.name[len(trace.PREFIX):]])
                 for e in evs if e.name[len(trace.PREFIX):] in STAGE_OF)
  if len(spans) != sum(s["calls"] for k, s in summary.items()
                       if k in STAGE_OF):
    return None
  out = {STAGE_OF[k]: Stage(0.0, 0, 0.0, s["syncs"])
         for k, s in summary.items() if k in STAGE_OF}
  for a, b, name in spans:
    out[name].host_ms += (b - a) / 1e3
  starts = [a for a, _, _ in spans]
  for e in evs:
    if not e.kernels:
      continue
    i = bisect.bisect_right(starts, e.time_range.start) - 1
    if i < 0 or e.time_range.start > spans[i][1]:
      continue                       # launched outside the stages
    st = out[spans[i][2]]
    st.ms += sum(k.duration for k in e.kernels) / 1e3
    st.kernels += len(e.kernels)
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
