"""Whole runs at a tiny size on the CPU (the program's plain twins in place
of its kernels), the look for a card skipped: a sound run comes out
correct against the reference, and ``correct`` comes out false for the
control (the reference in bfloat16 in the program's place) and for each
fault a cell can have (``splatbench.faults``).  The ``gpu`` test runs a
cell on the card for a few seconds."""

from __future__ import annotations

import json
import os

import pytest
import torch

from splatbench import faults, harness, run

CELLS = [w["name"] for w in harness.spec()["workloads"]]
# a view's sample is drawn from its first 32 views (36 due a second)
SECONDS = {"view.uniform2m": 1.0}


@pytest.fixture(scope="module")
def tiny_spec(tmp_path_factory):
  """BENCHMARK.json with every configuration cut to 2,000 splats at
  256x192 (16 x 12 tiles)."""
  spec = harness.spec()
  out = tmp_path_factory.mktemp("configs")
  for c in spec["configs"]:
    cfg = harness.load_json(harness.ROOT, c["file"])
    cfg.update(splats=2000, image_size=[256, 192], reference_block=1 << 22)
    path = os.path.join(out, c["name"] + ".json")
    with open(path, "w") as fh:
      json.dump(cfg, fh)
    c["file"] = path
  return spec


def tiny_run(cell, spec, seed=7, trace=0):
  args = run.parse(["--workload", cell, "--seed", str(seed), "--seconds",
                    str(SECONDS.get(cell, 0.5)), "--trace", str(trace)])
  return run.run(args, dev=torch.device("cpu"), spec=spec)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, tiny_spec):
  result, lines = tiny_run(cell, tiny_spec)
  assert result["correct"], result["checks"]
  assert result["failed"] == 0 and result["attempted"] > 0
  assert list(result)[-1] == "checks"
  assert len(lines) == len(result["checks"])
  names = {m["name"] for m in harness.Cell(cell, tiny_spec).end_to_end}
  assert set(result["metrics"]) == names


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, tiny_spec):
  c = harness.Cell(cell, tiny_spec)
  loop = c.loop().Loop(c, torch.device("cpu"), 11, harness.Timer(False))
  correct, checks = harness.report_checks(loop.control(), c.limits)
  assert not correct, checks


FAULTS = [(cell, fault) for cell in CELLS for fault in faults.FAULTS.values()
          if faults.applies(fault, cell)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_fault_is_not_correct(cell, fault, tiny_spec, monkeypatch):
  fault(monkeypatch.setattr)
  result, _ = tiny_run(cell, tiny_spec)
  assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_its_metrics_on_the_cpu(cell, tiny_spec):
  """Without a card there is no trace: only the readers that need none
  report (the calibration's time, and a view cell's latency tail and
  generator lateness), and no device number is written."""
  result, _ = tiny_run(cell, tiny_spec, trace=1)
  host = {"calibrate_s"} | ({"render_p95_ms", "generator_late_ms.serve"}
                            if cell.startswith("view") else set())
  assert set(result["metrics"]) == host
  assert "busy_s" not in result["device"]


@pytest.mark.gpu
def test_cell_on_the_card():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device")
  args = run.parse(["--workload", "view.uniform2m", "--seed", "5",
                    "--seconds", "2"])
  result, _ = run.run(args)
  assert result["correct"], result["checks"]
  assert result["device"]["platform"] == "gpu"
