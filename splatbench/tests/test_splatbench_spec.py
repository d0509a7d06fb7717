"""The benchmark's files: every name in BENCHMARK.json resolves to its
files, names and units keep to their characters, and the harness imports
neither JAX nor the JAX package, nor the program's own bench, and its
reference nothing of the program."""

from __future__ import annotations

import ast
import json
import os
import re

import pytest

from splatbench import harness

HERE = harness.HERE
SPEC = harness.spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def sources(sub=""):
  root = os.path.join(HERE, sub)
  for d, _, files in os.walk(root):
    for f in files:
      if f.endswith(".py"):
        yield os.path.join(d, f)


def imported(path):
  """Every module name a file imports (relative imports resolved)."""
  tree = ast.parse(open(path).read(), path)
  rel = os.path.relpath(path, harness.ROOT)
  package = os.path.dirname(rel).replace(os.sep, ".")
  names = set()
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      names.update(a.name for a in node.names)
    elif isinstance(node, ast.ImportFrom):
      base = node.module or ""
      if node.level:
        parts = package.split(".")
        parts = parts[:len(parts) - node.level + 1]
        base = ".".join(parts + ([base] if base else []))
      names.add(base)
      names.update(f"{base}.{a.name}" for a in node.names)
  return names


def test_top_level_keys_and_limits():
  assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
  assert SPEC["paths"] == ["splatbench"]
  assert 1 <= SPEC["run_seconds"] <= 51
  assert len(json.dumps(SPEC)) < 64 * 1024
  for e in SPEC["end_to_end"]:
    assert 0 < e["bound"] <= 0.25 and e["source"] in ("host_clock",
                                                      "device_trace")
  assert any(e["name"] == "setup_s" for e in SPEC["end_to_end"])


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units(kind):
  names = [e["name"] for e in SPEC[kind]]
  assert len(set(names)) == len(names)
  for e in SPEC[kind]:
    assert NAME.match(e["name"]), e["name"]
    if "unit" in e:
      assert UNIT.match(e["unit"]), e["unit"]
      assert e["better"] in ("lower", "higher")
    for text in ("why", "layer", "source"):
      if text in e:
        assert 1 <= len(e[text]) <= 200 and "\n" not in e[text]


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_resolves_by_name(cell):
  c = harness.Cell(cell, SPEC)
  assert c.chips == 1
  assert hasattr(c.loop(), "Loop")
  assert c.limits, f"limits/{cell}.json"
  assert any(m["name"] != "setup_s" for m in c.end_to_end)
  assert any(m["name"] == "setup_s" for m in c.end_to_end)
  assert c.per_layer
  for m in c.per_layer:
    assert callable(harness.metric_reader(m["name"]))
    moved = {e["name"] for e in c.end_to_end}
    assert m["moves"] in moved


def test_configs_files_and_reductions():
  used = {w["config"] for w in SPEC["workloads"]}
  files = [c["file"] for c in SPEC["configs"]]
  assert len(set(files)) == len(files)
  for c in SPEC["configs"]:
    assert c["name"] in used
    assert c["file"].startswith("splatbench/")
    cfg = harness.load_json(harness.ROOT, c["file"])
    assert cfg["reduced"] == c["reduced"]


def test_no_jax_and_no_bench():
  """No module of the harness imports jax, jaxlib, flax or the JAX package
  (top-level names compared whole), the root bench, benchmarks/, or the
  program's bench and benchmarks."""
  banned_top = {"jax", "jaxlib", "flax", "tpu_splatting", "bench",
                "benchmarks"}
  banned = ("tpu_splatting_torch.bench", "tpu_splatting_torch.benchmarks")
  for path in sources():
    for name in imported(path):
      assert name.split(".")[0] not in banned_top, (path, name)
      assert not any(name == b or name.startswith(b + ".") for b in banned), (
          path, name)
    # the calibration caches of the JAX bench and of the program's bench
    assert "bench" + "_cal" not in open(path).read(), path


def test_reference_imports_nothing_of_the_program():
  for path in sources("reference"):
    for name in imported(path):
      top = name.split(".")[0]
      assert top not in ("tpu_splatting_torch", "tpu_splatting"), (path, name)
      if top == "splatbench":
        assert name.startswith("splatbench.reference"), (path, name)
