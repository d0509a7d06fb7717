"""What every cell's run shares: the spec from ``BENCHMARK.json``, the card
check, the measured window, the traced session, the result line.

A cell's pieces are found by name: its configuration in
``configs/<config>.json``, its traffic mix in ``traffic/<mix>.json`` (whose
``loop`` names the driver in ``loops/``), its per-layer metrics' readers in
``metrics/<metric>.py`` and its correctness limits in
``limits/<cell>.json``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import statistics
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_splatting")
GIB = float(1 << 30)
# spin kernels around a traced session (~25 us each on an H100): the
# profiler then keeps the records of the session's last kernels
SPIN_CYCLES = 50_000


def process_start() -> float:
  """The epoch time this process started (from /proc), else now."""
  try:
    with open("/proc/self/stat") as fh:
      ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as fh:
      btime = next(int(line.split()[1]) for line in fh
                   if line.startswith("btime"))
    return btime + ticks / os.sysconf("SC_CLK_TCK")
  except (OSError, ValueError, IndexError, StopIteration):
    return time.time()


def load_json(*parts):
  with open(os.path.join(*parts)) as fh:
    return json.load(fh)


class Cell:
  """One workload of ``BENCHMARK.json`` and everything it names."""

  def __init__(self, name: str, spec: dict):
    by_name = {w["name"]: w for w in spec["workloads"]}
    if name not in by_name:
      raise SystemExit(f"splatbench: no workload {name!r} in BENCHMARK.json"
                       f" (have {sorted(by_name)})")
    self.entry = by_name[name]
    self.name = name
    cfg_entry = {c["name"]: c for c in spec["configs"]}[self.entry["config"]]
    self.config = load_json(ROOT, cfg_entry["file"])
    self.traffic = load_json(HERE, "traffic", self.entry["traffic"] + ".json")
    self.chips = int(self.entry["chips"])

    def mine(m):
      return name in m.get("workloads", [name])
    self.end_to_end = [m for m in spec["end_to_end"] if mine(m)]
    self.per_layer = [m for m in spec["per_layer"] if mine(m)]
    path = os.path.join(HERE, "limits", name + ".json")
    self.limits = load_json(path) if os.path.exists(path) else {}

  def loop(self):
    return importlib.import_module(f"splatbench.loops.{self.traffic['loop']}")


def spec(root=ROOT) -> dict:
  return load_json(root, "BENCHMARK.json")


def metric_reader(name: str):
  """``metrics/<name>.py``'s ``read(ctx)``."""
  path = os.path.join(HERE, "metrics", name + ".py")
  mod_spec = importlib.util.spec_from_file_location(
      "splatbench.metrics." + name.replace(".", "_"), path)
  mod = importlib.util.module_from_spec(mod_spec)
  mod_spec.loader.exec_module(mod)
  return mod.read


def card(chips: int) -> torch.device:
  """The card, or exit 2 without a result when there are too few."""
  if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
    print(f"splatbench: needs {chips} CUDA device(s), found "
          f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
          file=sys.stderr)
    raise SystemExit(2)
  return torch.device("cuda", 0)


def forbidden_modules():
  """Loaded modules whose top-level name is a forbidden one (compared
  whole: ``tpu_splatting_torch`` is not ``tpu_splatting``)."""
  return sorted({m.split(".")[0] for m in list(sys.modules)}
                & set(FORBIDDEN))


def sync(dev):
  if dev.type == "cuda":
    torch.cuda.synchronize(dev)


def quantile95(values):
  """The 95th percentile (statistics.quantiles, inclusive method)."""
  if len(values) < 2:
    return values[0] if values else None
  return statistics.quantiles(values, n=20, method="inclusive")[-1]


class Timer:
  """CUDA events around named calls; ``ms(name)`` is the mean."""

  def __init__(self, on: bool):
    self.on, self.events = on, {}

  def span(self, name):
    timer = self

    class _Span:
      def __enter__(self):
        if timer.on:
          self.start = torch.cuda.Event(enable_timing=True)
          self.start.record()

      def __exit__(self, *exc):
        if timer.on:
          end = torch.cuda.Event(enable_timing=True)
          end.record()
          timer.events.setdefault(name, []).append((self.start, end))
    return _Span()

  def ms(self, name):
    pairs = self.events.get(name)
    if not pairs:
      return None
    return statistics.fmean(a.elapsed_time(b) for a, b in pairs)


def traced_session(op, reps: int, dev):
  """One ``torch.profiler`` session of ``reps`` ops between spin kernels:
  {"kernels": {name: device s}, "busy_s", "window_s", "device_ops",
  "idle_gaps"}; window_s by CUDA events around the ops."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
    torch.cuda._sleep(SPIN_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
      op()
    end.record()
    torch.cuda._sleep(SPIN_CYCLES)
    sync(dev)
  window_s = start.elapsed_time(end) / 1e3
  dev_ev, host_ev = [], []
  for e in p.events():
    if e.device_type == DeviceType.CUDA:
      if "spin_kernel" not in e.name:
        dev_ev.append((e.time_range.start, e.time_range.end, e.name))
    elif e.time_range.end > e.time_range.start:
      host_ev.append((e.time_range.start, e.time_range.end, e.name))
  kernels = {}
  for s, t, name in dev_ev:
    kernels[name] = kernels.get(name, 0.0) + (t - s) / 1e6
  dev_ev.sort()
  busy, cur_s, cur_t = 0.0, None, None
  gaps = []
  for s, t, _ in dev_ev:
    if cur_t is None or s > cur_t:
      if cur_t is not None:
        busy += cur_t - cur_s
        gaps.append((s - cur_t, cur_t, s))
      cur_s, cur_t = s, t
    else:
      cur_t = max(cur_t, t)
  if cur_t is not None:
    busy += cur_t - cur_s
  gaps.sort(reverse=True)
  idle = []
  for length, a, b in gaps[:10]:
    mid = 0.5 * (a + b)
    inner = [h for h in host_ev if h[0] <= mid <= h[1]]
    what = min(inner, key=lambda h: h[1] - h[0])[2] if inner else "host idle"
    idle.append([what, length / 1e6])
  top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
  return {"ops": reps, "kernels": kernels, "busy_s": busy / 1e6,
          "window_s": window_s,
          "device_ops": [[k, v] for k, v in top], "idle_gaps": idle}


def report_checks(numbers: dict, limits: dict):
  """(correct, {name: {"value", "limit"}}); a number without a limit, or
  not finite, fails."""
  checks, correct = {}, True
  for name, value in numbers.items():
    limit = limits.get(name)
    ok = (limit is not None and value == value and abs(value) != float("inf")
          and value <= limit)
    correct = correct and ok
    checks[name] = {"value": value, "limit": limit}
  return correct and bool(numbers), checks
