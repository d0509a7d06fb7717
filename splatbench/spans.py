"""The program's own spans and host-sync counts in a traced run (``--trace
1``), for the per-layer readers that read them.

After the traced session, the first such reader runs a spans window:
``SPANS_OPS`` ops with the program's tracing on
(``tpu_splatting_torch.trace``), back to back (a view: each followed by
a synchronise, as in the measured window), in ``ROUNDS`` turns with as
many ops untraced, which time tracing's cost under the same conditions.
It reads ``trace.summary()``, then runs one ``torch.profiler`` session of
``SESSION_OPS`` ops between spin kernels, traced, and puts each device
record in the innermost span that launched it.  The rest read what it
left in the context:

* ``ctx["spans"]``: {"ops", "op_ms" (the traced ops' mean time),
  "off_ms" (the untraced ops' between them), "summary" (the program's
  ``trace.summary()`` of the traced ops), "harness_map_ms" (the mean of
  the harness's own events around ``stream_map`` in the traced ops, where
  the loop has them)};
* ``ctx["span_session"]``: ``attribute``'s reading of the session.

``run.py`` hands a reader the context alone; the loop and the card are
``run.run``'s own locals, found on the stack.  On a CPU (no traced
session), or where the program has no ``trace`` module, nothing is read.
"""

from __future__ import annotations

import importlib
import os
import sys
import time
import traceback

import torch

from . import harness

SPANS_OPS = 20
ROUNDS = 4           # the spans window in turns with as many ops untraced
SESSION_OPS = 3
PREFIX = "ts."
RUN_FILE = os.path.join(harness.HERE, "run.py")


def reading(ctx):
  """(ctx["spans"], ctx["span_session"]), measured on the first call."""
  if "spans" not in ctx:
    try:
      ctx["spans"], ctx["span_session"] = measure(ctx)
    except Exception:      # a traced run reports what it can read
      traceback.print_exc()
      ctx["spans"], ctx["span_session"] = None, None
  return ctx["spans"], ctx.get("span_session")


def run_locals():
  """``run.run``'s loop and card, from its frame on the stack."""
  frame = sys._getframe(1)
  while frame is not None:
    code = frame.f_code
    if code.co_name == "run" and code.co_filename == RUN_FILE:
      return frame.f_locals.get("loop"), frame.f_locals.get("dev")
    frame = frame.f_back
  return None, None


def measure(ctx):
  if ctx.get("session") is None:
    return None, None
  try:
    trace = importlib.import_module("tpu_splatting_torch.trace")
  except ImportError:
    return None, None
  loop, dev = run_locals()
  if loop is None:
    return None, None
  # the harness's own events around the 2D step's stream_map, in the
  # traced ops: the same call as the map span's
  timed = loop.timer.events.get("map", [])
  beside = []
  trace.reset()
  on_ms = off_ms = 0.0
  for _ in range(ROUNDS):
    off_ms += window_op_ms(loop, dev, SPANS_OPS // ROUNDS) / ROUNDS
    first = len(timed)
    trace.enable()
    try:
      on_ms += window_op_ms(loop, dev, SPANS_OPS // ROUNDS) / ROUNDS
    finally:
      trace.disable()
    beside += timed[first:]
  summary = trace.summary()
  trace.enable()
  try:
    session = session_spans(loop.op, SESSION_OPS, dev)
  finally:
    trace.disable()
    trace.reset()
  spans = {"ops": SPANS_OPS, "op_ms": on_ms, "off_ms": off_ms,
           "summary": summary,
           "harness_map_ms": (sum(a.elapsed_time(b) for a, b in beside)
                              / len(beside) if beside else None)}
  report(spans, session, ctx["op_ms"])
  return spans, session


def window_op_ms(loop, dev, ops: int) -> float:
  """The ops' mean time (ms): a step's over the steps back to back, a
  view's from its start to the synchronise after it."""
  harness.sync(dev)
  if loop.kind == "serve":
    total = 0.0
    for _ in range(ops):
      t0 = time.perf_counter()
      loop.op()
      harness.sync(dev)
      total += time.perf_counter() - t0
    return 1e3 * total / ops
  t0 = time.perf_counter()
  for _ in range(ops):
    loop.op()
  harness.sync(dev)
  return 1e3 * (time.perf_counter() - t0) / ops


def session_spans(op, reps: int, dev) -> dict:
  """One ``torch.profiler`` session of ``reps`` ops between spin kernels
  (as ``harness.traced_session``), read by ``attribute``."""
  from torch.profiler import ProfilerActivity, profile
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
    torch.cuda._sleep(harness.SPIN_CYCLES)
    for _ in range(reps):
      op()
    torch.cuda._sleep(harness.SPIN_CYCLES)
    harness.sync(dev)
  return attribute(p.events(), reps)


def group(name: str) -> str:
  """The span a reading is kept under: a ``map.*`` stage, else its
  top-level span."""
  return name if name.startswith("map.") else name.split(".")[0]


def attribute(events, ops: int) -> dict:
  """A session's events read by span: {"ops", "launches" (device
  records: kernels, copies, fills), "kernel_s" (their summed time),
  "busy_s" (merged), "spans": {span: {"kernels", "busy_s", "idle_s"}},
  "outside": {kernel: s launched in no span}, "idle_gaps": [[span, s]]
  (the 10 longest)}.  A device record counts in the innermost span that
  holds the host call that launched it (the runtime call of the same
  correlation id), a gap between records in the innermost span that
  holds its midpoint; innermost is the shortest, over all threads (the
  caller waits while the autograd engine's thread runs).  The spans'
  own device-side ranges are no records.  Spans kept: the top-level
  ones and the ``map.*`` stages."""
  from torch.autograd import DeviceType
  dev_ev, spans, launched = [], [], {}
  for e in events:
    if e.device_type == DeviceType.CUDA:
      if "spin_kernel" not in e.name and not e.name.startswith(PREFIX):
        dev_ev.append((e.time_range.start, e.time_range.end, e.name, e.id))
    elif e.name.startswith(PREFIX):
      spans.append((e.time_range.start, e.time_range.end,
                    group(e.name[len(PREFIX):])))
    elif e.name.startswith("cu"):          # the CUDA runtime's calls
      launched[e.id] = e.time_range.start

  def innermost(t):
    held = [s for s in spans if s[0] <= t <= s[1]]
    return min(held, key=lambda s: s[1] - s[0])[2] if held else None

  out = {}

  def entry(name):
    return out.setdefault(name, {"kernels": 0, "busy_s": 0.0, "idle_s": 0.0})

  outside = {}
  for s, t, name, corr in dev_ev:
    span = innermost(launched[corr]) if corr in launched else None
    if span is None:
      outside[name] = outside.get(name, 0.0) + (t - s) / 1e6
    else:
      entry(span)["kernels"] += 1
      entry(span)["busy_s"] += (t - s) / 1e6
  dev_ev.sort()
  busy, cur_s, cur_t, gaps = 0.0, None, None, []
  for s, t, _, _ in dev_ev:
    if cur_t is None or s > cur_t:
      if cur_t is not None:
        busy += cur_t - cur_s
        gaps.append((s - cur_t, cur_t, s))
      cur_s, cur_t = s, t
    else:
      cur_t = max(cur_t, t)
  if cur_t is not None:
    busy += cur_t - cur_s
  named = []
  for length, a, b in sorted(gaps, reverse=True):
    span = innermost(0.5 * (a + b))
    if span is not None:
      entry(span)["idle_s"] += length / 1e6
    named.append([span or "outside", length / 1e6])
  return {"ops": ops, "launches": len(dev_ev),
          "kernel_s": sum(t - s for s, t, _, _ in dev_ev) / 1e6,
          "busy_s": busy / 1e6,
          "spans": out, "outside": outside, "idle_gaps": named[:10]}


def report(spans, session, measured_ms):
  """What the readers do not print, on standard error: tracing's cost
  (against the untraced ops beside the spans window, and against the
  measured window's), each span, the session's kernel time in no span,
  and its longest idle gaps by span."""
  err = sys.stderr
  on, off = spans["op_ms"], spans["off_ms"]
  print(f"splatbench spans: op_ms {on:.4f} traced over {spans['ops']} ops, "
        f"{off:.4f} untraced beside it ({100.0 * (on / off - 1.0):+.2f}%), "
        f"{measured_ms:.4f} in the measured window "
        f"({100.0 * (on / measured_ms - 1.0):+.2f}%)", file=err)
  if spans["harness_map_ms"] is not None:
    print(f"splatbench spans: the harness's map events over the same "
          f"traced ops {spans['harness_map_ms']:.4f} ms", file=err)
  for name, s in spans["summary"].items():
    print(f"splatbench span {name}: calls {s['calls']} device_ms "
          f"{s['device_ms']:.4f} host_ms {s['host_ms']:.4f} syncs "
          f"{s['syncs']}", file=err)
  ops = session["ops"]
  in_spans = sum(v["busy_s"] for v in session["spans"].values())
  print(f"splatbench session: {session['launches'] / ops:.1f} launches/op, "
        f"kernel time {1e3 * session['kernel_s'] / ops:.4f} ms/op, "
        f"{100.0 * in_spans / max(session['kernel_s'], 1e-12):.2f}% of it "
        f"in spans", file=err)
  for name, v in session["spans"].items():
    print(f"splatbench session span {name}: {v['kernels'] / ops:.1f} "
          f"kernels/op busy {1e3 * v['busy_s'] / ops:.4f} ms/op idle "
          f"{1e3 * v['idle_s'] / ops:.4f} ms/op", file=err)
  rest = sorted(session["outside"].items(), key=lambda kv: -kv[1])
  print("splatbench session outside spans: " + "; ".join(
      f"{k[:60]} {1e3 * v / ops:.4f} ms/op" for k, v in rest), file=err)
  print("splatbench session idle gaps: " + "; ".join(
      f"{name} {1e3 * s:.4f} ms" for name, s in session["idle_gaps"]),
      file=err)


def span_ms(ctx, *names):
  """The named spans' device ms per op in the spans window (their CUDA
  events, each over all its calls), or None."""
  spans, _ = reading(ctx)
  if spans is None:
    return None
  got = [spans["summary"][n] for n in names if n in spans["summary"]]
  if not got:
    return None
  return sum(s["device_ms"] * s["calls"] for s in got) / spans["ops"]


def host_syncs(ctx):
  """The host syncs per op that the program's spans counted."""
  spans, _ = reading(ctx)
  if spans is None:
    return None
  return sum(s["syncs"] for s in spans["summary"].values()) / spans["ops"]


def launches(ctx):
  """Device records (kernels, copies, fills) per op in the session."""
  _, session = reading(ctx)
  if session is None:
    return None
  return session["launches"] / session["ops"]


def map_idle_ms(ctx):
  """The device's idle ms per op while the host was in ``stream_map``:
  the ``map`` span's ms by its events in the spans window, less the busy
  time per op of the records launched under ``map`` in the session.  (The
  session's own gaps under ``map`` read longer: the profiler's host cost
  per op stretches a stage that waits on the host's launches.)"""
  mapper = span_ms(ctx, "map")
  _, session = reading(ctx)
  if mapper is None or session is None:
    return None
  busy = sum(v["busy_s"] for k, v in session["spans"].items()
             if k == "map" or k.startswith("map."))
  return mapper - 1e3 * busy / session["ops"]
