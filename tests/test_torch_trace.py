"""``tpu_splatting_torch.trace``: the program's named spans and host-sync
counts.  Off, a span is a shared no-op (no profiler range, no tensor hook,
nothing recorded); on, ``stream_map`` enters its seven stages once each,
in order, the training step yields its span tree with the backward phases
inside ``backward``, and no number of the step changes; ``map.wide_dup``
counts the mapping's own wide splats and duplicate rows, summed over
calls, and nothing with tracing off.  The ``gpu`` test counts a host sync
on the card."""

import dataclasses
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpu_splatting_torch import (bench, calibrate_stream,
                                 render_with_heuristics, stream_map, trace)
from tpu_splatting_torch.optim import GroupConfig, VisibilityAwareAdam
from tpu_splatting_torch.rasterizer.stream import wide_stats

SIZE = (64, 32)
HEAVY_SIZE = (128, 96)
MAP_STAGES = ["map.bounds", "map.wide_dup", "map.sort", "map.edges",
              "map.strips", "map.descriptors", "map.grad_gather"]
TOP = ["project", "sh", "map", "k1", "backward", "optimizer"]
BACKWARD = ["backward.raster", "backward.sh", "backward.project"]


@dataclasses.dataclass
class Full:
  g3d: object
  cam: object
  config: object
  tgt: torch.Tensor
  mask: torch.Tensor

  def loss(self, rendering):
    err = rendering.image - self.tgt
    return (self.mask * err * err).sum()


@pytest.fixture(scope="module")
def full():
  """The bench's uniform scene at 100 splats, 64x32, lifted to 3D and
  calibrated (group width 4; no calibration cache)."""
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(bench, "_cal_cached", lambda key, compute, force=False:
               compute())
    g3d, cam, cal = bench.lift_and_calibrate(
        "uniform", *bench.scene_arrays("uniform", 100, SIZE), 4, SIZE,
        "cpu")
  config = bench.full_config(cal, 4)
  return Full(g3d, cam, config, *bench.loss_target(SIZE, config.tile_size,
                                                   "cpu"))


@pytest.fixture
def tracing():
  trace.reset()
  trace.enable()
  yield
  trace.disable()
  trace.reset()


def train_step(full):
  """One ``render_with_heuristics`` step and one optimizer step: (every
  number they produce, the rendering)."""
  loss, rendering, grads = render_with_heuristics(
      full.loss, full.g3d, full.cam, full.config, use_sh=True, tiled=True)
  points = rendering.points
  opt = VisibilityAwareAdam({"feature": GroupConfig(lr=1e-3)})
  params, _ = opt.step({"feature": full.g3d.feature},
                       {"feature": grads.feature},
                       opt.init({"feature": full.g3d.feature}),
                       points.visibility)
  numbers = [loss, rendering.image, points.visibility, points.prune_cost,
             points.split_score, params["feature"],
             *(getattr(grads, f.name) for f in dataclasses.fields(grads))]
  return numbers, rendering


def ranges(prof):
  """[(name without the prefix, start, end)] of the session's spans, by
  start."""
  return sorted(((e.name[len(trace.PREFIX):], e.time_range.start,
                  e.time_range.end) for e in prof.events()
                 if e.name.startswith(trace.PREFIX)), key=lambda r: r[1])


def test_off_path_records_nothing(full):
  trace.reset()
  assert trace.span("project") is trace.span("map")
  with profile(activities=[ProfilerActivity.CPU]) as prof:
    _, rendering = train_step(full)
  assert ranges(prof) == []
  assert not rendering.points.gaussians2d._backward_hooks
  assert not rendering.points.features._backward_hooks
  assert trace.summary() == {}


@pytest.fixture(scope="module")
def heavy():
  """The bench's heavy scene at 2,000 splats, 128x96, and its calibrated
  capacities (group width 8): it has wide splats and duplicate rows."""
  s = bench.scene_arrays("heavy", 2000, HEAVY_SIZE)
  packed, depth, feats = (torch.from_numpy(x) for x in s)
  config = bench._trainer_config(8)
  cal = calibrate_stream(packed, depth, feats, HEAVY_SIZE, config,
                         group_width=8)
  return packed, depth, feats, config, {k: cal[k] for k in bench.MAP_KEYS}


def heavy_map(heavy, shift=0.0):
  packed, depth, feats, config, caps = heavy
  packed = packed.clone()
  packed[:, :2] += shift
  return stream_map(packed, depth, feats, HEAVY_SIZE, config, **caps,
                    group_width=8)


def test_stream_map_enters_its_stages_in_order(heavy, tracing):
  with profile(activities=[ProfilerActivity.CPU]) as prof:
    heavy_map(heavy)
  got = ranges(prof)
  assert [name for name, _, _ in got] == ["map"] + MAP_STAGES
  (_, start, end) = got[0]
  assert all(start <= a and b <= end for _, a, b in got[1:])
  assert all(b <= a for (_, _, b), (_, a, _) in zip(got[1:], got[2:]))
  summary = trace.summary()
  assert list(summary) == ["map"] + MAP_STAGES
  assert all(s["calls"] == 1 and s["host_ms"] > 0 and s["syncs"] == 0
             for s in summary.values())


def test_wide_dup_counts_are_the_mappings_own(heavy, tracing):
  m = heavy_map(heavy)
  packed, depth, _, config, _ = heavy
  num_wide, _, _ = wide_stats(packed, depth, HEAVY_SIZE, config)
  counts = trace.summary()["map.wide_dup"]["counts"]
  assert counts == {"wide": int(num_wide),
                    "dup_rows": int((m.dup_pid < m.num_points).sum())}
  assert 0 < counts["wide"] < counts["dup_rows"]
  assert all("counts" not in s for name, s in trace.summary().items()
             if name != "map.wide_dup")


def test_wide_dup_counts_sum_over_calls(heavy, tracing):
  alone = []
  for shift in (0.0, 7.0):
    trace.reset()
    heavy_map(heavy, shift)
    alone.append(trace.summary()["map.wide_dup"]["counts"])
  assert alone[0] != alone[1]
  trace.reset()
  for shift in (0.0, 7.0, 0.0):
    heavy_map(heavy, shift)
  summed = trace.summary()["map.wide_dup"]
  assert summed["calls"] == 3
  assert summed["counts"] == {k: 2 * alone[0][k] + alone[1][k]
                              for k in alone[0]}


def test_counts_record_nothing_with_tracing_off(heavy):
  def made():
    raise AssertionError("a count's callable ran with tracing off")

  trace.reset()
  heavy_map(heavy)
  with trace.span("outer"):
    trace.count(wide=1, dup_rows=made)
  assert trace._pending_counts == [] and trace.summary() == {}
  trace.enable()
  try:
    trace.count(wide=1)       # outside every span
  finally:
    trace.disable()
  assert trace._pending_counts == [] and trace.summary() == {}


def test_training_step_yields_the_span_tree(full, tracing):
  with profile(activities=[ProfilerActivity.CPU]) as prof:
    train_step(full)
  got = ranges(prof)
  names = [name for name, _, _ in got]
  assert sorted(names) == sorted(TOP + MAP_STAGES + BACKWARD)
  assert [n for n in names if "." not in n] == TOP
  at = {name: (a, b) for name, a, b in got}
  # the backward phases, in the order autograd reaches them, inside
  # backward, which follows the forward's spans
  starts = [at[n][0] for n in BACKWARD]
  assert starts == sorted(starts)
  for name in BACKWARD:
    assert at["backward"][0] <= at[name][0] <= at[name][1] <= \
        at["backward"][1], name
  assert at["k1"][1] <= at["backward"][0] <= at["optimizer"][0]
  summary = trace.summary()
  assert set(summary) == set(names)
  assert all(s["calls"] == 1 for s in summary.values())


def test_tracing_changes_no_number(full):
  off, _ = train_step(full)
  trace.reset()
  trace.enable()
  try:
    on, _ = train_step(full)
  finally:
    trace.disable()
    trace.reset()
  assert len(on) == len(off)
  for a, b in zip(on, off):
    assert torch.equal(a, b)


def test_threads_lose_no_span(tracing):
  """More threads than cores, each entering spans with a short switch
  interval: every call is counted, and each thread's stack unwinds."""
  import sys
  import threading

  def work():
    for _ in range(300):
      with trace.span("outer"):
        with trace.span("inner"):
          pass

  interval = sys.getswitchinterval()
  sys.setswitchinterval(1e-6)
  try:
    threads = [threading.Thread(target=work) for _ in range(32)]
    for t in threads:
      t.start()
    for t in threads:
      t.join(timeout=60)
  finally:
    sys.setswitchinterval(interval)
  assert not any(t.is_alive() for t in threads)
  summary = trace.summary()
  assert summary["outer"]["calls"] == summary["inner"]["calls"] == 32 * 300
  assert not trace._open


@pytest.mark.gpu
def test_a_sync_inside_a_span_is_counted_on_the_card():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device")
  before = (torch.cuda.get_sync_debug_mode(), len(warnings.filters),
            warnings.showwarning)
  x = torch.ones(1000, device="cuda")
  trace.reset()
  trace.enable()
  try:
    with trace.span("outer"):
      with trace.span("inner"):
        x.sum().item()
      y = x * 2
  finally:
    trace.disable()
  summary = trace.summary()
  trace.reset()
  assert summary["inner"]["syncs"] == 1 and summary["outer"]["syncs"] == 0
  assert summary["outer"]["device_ms"] >= summary["inner"]["device_ms"] >= 0
  assert float(y.sum()) == 2000.0
  assert (torch.cuda.get_sync_debug_mode(), len(warnings.filters),
          warnings.showwarning) == before
