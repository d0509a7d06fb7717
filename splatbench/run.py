"""Run one cell of the benchmark and print its result line.

    python3 -m splatbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Set-up makes the cell's inputs from the seed, calibrates, and runs the
first steps (or views) through the window's own call: those build every
kernel, and a training cell records what its check compares.  The window
then drives the same loop for ``--seconds``.  With ``--trace 1`` the run
reports the cell's per-layer metrics instead of its end-to-end ones:
CUDA events around the harness's own calls during the window, then one
short ``torch.profiler`` session.  Once the window has closed (and the
peak memory has been read) the program's state is freed and the plain
reference checks the outputs; each number compared is printed beside its
limit, last on standard error and last in the result line.

Without enough CUDA devices it exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
import time
import traceback

import torch

from . import harness

# the traced session's ops: a few, so the profiler keeps every record
TRACED_OPS = 3
# a view due in the window may start this long after its close
GRACE_S = 60.0


def parse(argv=None):
  ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  ap.add_argument("--workload", required=True)
  ap.add_argument("--seed", type=int, required=True)
  ap.add_argument("--seconds", type=float, required=True)
  ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
  return ap.parse_args(argv)


def window(loop, seconds: float, dev):
  """The window's ops: (attempted, failed, seconds, latencies in ms,
  service times in ms, the generator's lateness in ms).  A training loop
  steps back to back for ``seconds``.  A serving loop is an open loop at
  its traffic's fixed rate: view k is due at k / rate for every
  k / rate < seconds, starts when due or when the view before it is done,
  and its latency runs from when it was due to the synchronise after it;
  the generator was late by how much later than that it started.  A view
  not started within ``GRACE_S`` of the window's close counts as failed."""
  serve = loop.kind == "serve"
  bad = torch.zeros((), dtype=torch.int64, device=dev)
  ops, failed, lat, svc, late = 0, 0, [], [], []
  harness.sync(dev)
  t0 = time.perf_counter()
  end = t0 + seconds
  done = t0
  due_total = math.ceil(seconds * loop.rate) if serve else None
  while ops != due_total:
    now = time.perf_counter()
    due = t0 + ops / loop.rate if serve else now
    if (not serve and now >= end) or now >= end + GRACE_S:
      break
    if serve:
      # sleep to within a millisecond of the due time, then spin: the
      # host's wake-up jitter is not the program's latency
      time.sleep(max(0.0, due - now - 1e-3))
      while time.perf_counter() < due:
        pass
    start, done_before = time.perf_counter(), done
    try:
      bad += loop.op()
    except Exception:     # counted as failed, the window goes on
      traceback.print_exc()
      failed += 1
    if serve:
      harness.sync(dev)
      done = time.perf_counter()
      lat.append((done - due) * 1e3)
      svc.append((done - start) * 1e3)
      late.append((start - max(due, done_before)) * 1e3)
      loop.keep(ops)
    ops += 1
  harness.sync(dev)
  attempted = due_total if serve else ops
  return (attempted, failed + int(bad) + attempted - ops,
          time.perf_counter() - t0, lat, svc, late)


def run(args, dev=None, spec=None, t_start=None):
  """One run: (result dict, check lines).  ``dev`` given (the tests)
  skips the look for a card."""
  t_start = harness.process_start() if t_start is None else t_start
  cell = harness.Cell(args.workload, spec or harness.spec())
  dev = harness.card(cell.chips) if dev is None else dev
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  timer = harness.Timer(args.trace == 1 and dev.type == "cuda")
  loop = cell.loop().Loop(cell, dev, args.seed, timer)
  harness.sync(dev)
  t0 = time.perf_counter()
  loop.calibrate()
  harness.sync(dev)
  calibrate_s = time.perf_counter() - t0
  loop.warm()
  harness.sync(dev)
  setup_s = time.time() - t_start
  timer.events.clear()
  if dev.type == "cuda":
    torch.cuda.reset_peak_memory_stats(dev)
  ops, failed, window_s, lat, svc, late = window(loop, args.seconds, dev)
  peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
  device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": cell.chips, "memory_peak_bytes": int(peak)}
  # a step's time: the window over the steps; a view's: its service time
  op_ms = statistics.fmean(svc) if svc else 1e3 * window_s / ops
  ctx = {"op_ms": op_ms, "calibrate_s": calibrate_s, "timer": timer,
         "latency_ms": lat, "late_ms": late}
  result = {"correct": False, "attempted": ops, "failed": failed}
  if args.trace:
    if dev.type == "cuda":
      ctx["session"] = harness.traced_session(loop.op, TRACED_OPS, dev)
      device["busy_s"] = ctx["session"]["busy_s"]
      device["window_s"] = ctx["session"]["window_s"]
    ctx["work"] = loop.work()
    metrics = {}
    for m in cell.per_layer:
      value = harness.metric_reader(m["name"])(ctx)
      if value is not None:
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
  else:
    values = {"step_ms": op_ms,
              "render_ms": statistics.median(lat) if lat else None,
              "peak_gib": peak / harness.GIB, "setup_s": setup_s}
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in cell.end_to_end}
  result["metrics"] = metrics
  result["device"] = device
  if args.trace and "session" in ctx:
    result["breakdown"] = {"device_ops": ctx["session"]["device_ops"],
                           "idle_gaps": ctx["session"]["idle_gaps"]}
  found = harness.forbidden_modules()
  if found:
    raise SystemExit(f"splatbench: the process holds {found} after its "
                     f"window")
  loop.free()
  if dev.type == "cuda":
    torch.cuda.empty_cache()
  t_check = time.perf_counter()
  numbers = loop.check()
  check_s = time.perf_counter() - t_check
  print(f"splatbench {cell.name} seed {args.seed}: calibrate_s "
        f"{calibrate_s:.3f} setup_s {setup_s:.3f} window_s {window_s:.3f} "
        f"ops {ops} check_s {check_s:.3f}", file=sys.stderr)
  if lat:
    print(f"splatbench {cell.name} seed {args.seed}: latency p50 "
          f"{statistics.median(lat):.4f} p95 {harness.quantile95(lat):.4f} "
          f"service p50 {statistics.median(svc):.4f} p95 "
          f"{harness.quantile95(svc):.4f} generator late max {max(late):.4f}"
          f" ms", file=sys.stderr)
  correct, checks = harness.report_checks(numbers, cell.limits)
  result["correct"] = correct
  result["checks"] = checks
  lines = [f"check {k}: {v['value']!r} limit {v['limit']!r}"
           for k, v in checks.items()]
  return result, lines


def main(argv=None) -> int:
  t_start = harness.process_start()
  args = parse(argv)
  result, lines = run(args, t_start=t_start)
  print(json.dumps(result), flush=True)
  for line in lines:
    print(line, file=sys.stderr)
  sys.stderr.flush()
  return 0


if __name__ == "__main__":
  sys.exit(main())
