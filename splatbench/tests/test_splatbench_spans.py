"""The readers of the program's spans (``splatbench/spans.py``), on the
CPU: without a traced session, or where the program has no spans, each
reads nothing; from a synthetic context each reads its number; the
session's events are put in the innermost span that launched them."""

from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from splatbench import harness, spans

NEW = ["proj_sh_ms.train", "proj_sh_ms.serve", "mapper_ms.train",
       "mapper_ms.serve", "k2_reduce_ms.train", "backward_tail_ms.train",
       "host_syncs.train", "host_syncs.serve", "launches.train",
       "launches.serve", "map_idle_ms.train", "map_idle_ms.serve"]


def test_the_new_metrics_are_in_the_spec():
  names = [m["name"] for m in harness.spec()["per_layer"]]
  assert names[-len(NEW):] == NEW


@pytest.mark.parametrize("name", NEW)
def test_reader_reads_nothing_without_a_trace(name):
  ctx = {"op_ms": 10.0, "calibrate_s": 1.5, "timer": harness.Timer(False)}
  assert harness.metric_reader(name)(ctx) is None


@pytest.mark.parametrize("name", NEW)
def test_reader_reads_nothing_without_the_programs_spans(name, monkeypatch):
  """A traced session but no ``tpu_splatting_torch.trace`` (a program
  without spans): nothing is read, nothing raises."""
  monkeypatch.setitem(sys.modules, "tpu_splatting_torch.trace", None)
  ctx = {"op_ms": 10.0, "session": {"ops": 3}}
  assert harness.metric_reader(name)(ctx) is None


def test_no_run_frame_reads_nothing():
  """Outside ``run.run`` there is no loop to trace."""
  assert spans.run_locals() == (None, None)
  assert spans.measure({"op_ms": 1.0, "session": {"ops": 3}}) == (None, None)


def test_run_locals_finds_the_runs_loop(monkeypatch):
  monkeypatch.setattr(spans, "RUN_FILE", __file__)

  def run():
    loop, dev = "the loop", "the card"  # noqa: F841
    return spans.run_locals()
  assert run() == ("the loop", "the card")


def synthetic():
  """20 steps' summary and a 3-step session's reading."""
  def s(calls, device_ms, syncs=0):
    return {"calls": calls, "device_ms": device_ms, "host_ms": 0.1,
            "syncs": syncs}
  summary = {"project": s(20, 3.0, 20), "sh": s(20, 5.0), "map": s(20, 7.0),
             "map.descriptors": s(20, 4.0, 60), "k1": s(20, 2.5),
             "backward": s(20, 20.0), "backward.raster": s(20, 9.0, 20),
             "backward.sh": s(20, 6.0), "backward.project": s(20, 5.0),
             "optimizer": s(20, 7.7)}
  session = {"ops": 3, "launches": 1500, "kernel_s": 0.12, "busy_s": 0.12,
             "spans": {"map": {"kernels": 30, "busy_s": 0.003,
                               "idle_s": 0.0015},
                       "map.descriptors": {"kernels": 600, "busy_s": 0.009,
                                           "idle_s": 0.006},
                       "k1": {"kernels": 3, "busy_s": 0.0075,
                              "idle_s": 0.0}},
             "outside": {}, "idle_gaps": []}
  return {"op_ms": 50.0, "spans": {"ops": 20, "op_ms": 50.5,
                                   "summary": summary},
          "span_session": session}


@pytest.mark.parametrize("name,want", [
    ("proj_sh_ms.train", 8.0), ("proj_sh_ms.serve", 8.0),
    ("mapper_ms.train", 7.0), ("mapper_ms.serve", 7.0),
    ("k2_reduce_ms.train", 9.0), ("backward_tail_ms.train", 11.0),
    # 20 + 60 + 20 syncs over 20 steps
    ("host_syncs.train", 5.0), ("host_syncs.serve", 5.0),
    ("launches.train", 500.0), ("launches.serve", 500.0),
    # 7 ms in map less (3 + 9) ms busy over 3 steps
    ("map_idle_ms.train", 3.0), ("map_idle_ms.serve", 3.0)])
def test_reader_reads_a_synthetic_context(name, want):
  assert harness.metric_reader(name)(synthetic()) == pytest.approx(want)


def test_a_span_the_cell_lacks_reads_nothing():
  ctx = synthetic()
  del ctx["spans"]["summary"]["backward.sh"]
  del ctx["spans"]["summary"]["backward.project"]
  assert harness.metric_reader("backward_tail_ms.train")(ctx) is None


def host(name, start, end, thread=1, corr=0):
  return SimpleNamespace(device_type=DeviceType.CPU, name=name, id=corr,
                         time_range=SimpleNamespace(start=start, end=end),
                         thread=thread, kernels=[])


def device(name, start, end, corr):
  return SimpleNamespace(device_type=DeviceType.CUDA, name=name, id=corr,
                         time_range=SimpleNamespace(start=start, end=end),
                         thread=0, kernels=[])


def test_attribute_puts_kernels_and_gaps_in_the_innermost_span():
  """Times in us.  ``map`` (0-100) holds ``map.sort`` (10-40); the
  backward (200-400) holds ``backward.raster`` on the autograd thread 2
  (210-300).  Each record pairs with its launch call by correlation id;
  the spans' own device-side ranges and the spin kernels are no
  records."""
  events = [
      host("ts.map", 0, 100), host("ts.map.sort", 10, 40),
      host("aten::zeros", 2, 4), host("cudaLaunchKernel", 3, 4, corr=1),
      host("aten::sort", 12, 20), host("cudaLaunchKernel", 13, 14, corr=2),
      host("cudaLaunchKernel", 15, 16, corr=3),
      host("ts.k1", 150, 160), host("cudaLaunchKernel", 151, 152, corr=4),
      host("ts.backward", 200, 400),
      host("ts.backward.raster", 210, 300, thread=2),
      host("cudaLaunchKernel", 221, 222, thread=2, corr=5),
      host("cudaLaunchKernel", 500, 501, corr=6),
      device("fill", 5, 10, 1), device("radix", 30, 50, 2),
      device("radix", 50, 60, 3), device("stream_forward", 170, 200, 4),
      device("gemm", 260, 300, 5), device("add", 510, 512, 6),
      device("ts.map", 5, 60, 0), device("spin_kernel", 600, 700, 7)]
  got = spans.attribute(events, 1)
  assert got["launches"] == 6
  assert got["kernel_s"] == pytest.approx(107e-6)
  assert got["busy_s"] == pytest.approx(107e-6)
  assert got["spans"]["map"] == pytest.approx(
      {"kernels": 1, "busy_s": 5e-6, "idle_s": 0.0})
  assert got["spans"]["map.sort"] == pytest.approx(
      {"kernels": 2, "busy_s": 30e-6, "idle_s": 20e-6})
  assert got["spans"]["k1"]["busy_s"] == pytest.approx(30e-6)
  assert got["spans"]["backward"]["kernels"] == 1
  assert got["outside"] == pytest.approx({"add": 2e-6})
  # gaps: 10-30 (mid 20: map.sort), 60-170 (mid 115: no span), 200-260
  # (mid 230: backward.raster, kept under backward), 300-510 (mid 405)
  assert got["idle_gaps"] == [["outside", pytest.approx(210e-6)],
                              ["outside", pytest.approx(110e-6)],
                              ["backward", pytest.approx(60e-6)],
                              ["map.sort", pytest.approx(20e-6)]]
  assert got["spans"]["backward"]["idle_s"] == pytest.approx(60e-6)
