"""The diagnostic scripts of ``tpu_splatting_torch.benchmarks``: the
counterparts of ``benchmarks/profile_*.py`` and ``benchmarks/exp_{mapper,
reduce,rowgather,layout,precision}.py``.

Each module's ``main`` runs with ``--device cpu`` at a small size and
prints a line for every label its reference script times, the labels read
from the reference's text (``benchmarked("...")``, ``run("...")``,
``raster_ms("...")``; an f-string label matches any value of its fields).
Each module, imported alone, brings in no JAX, nothing of the JAX package
and nothing of ``benchmarks/``.  Where a script computes what its
reference computes, the two are held together on the same seeded inputs:
``profile_map``'s seven ``stream_map`` variants (every integer field and
overflow count exactly), ``profile_glue2``'s v2 gradient against the JAX
composition (within 1e-4 of each column's largest value; the reference
runs its Pallas kernels in interpret mode, as tests/conftest.py sets it)
and ``exp_reduce``'s reduce against the JAX ``segment_sum_sorted`` (exact,
on dyadic rows).  ``profile_map2``'s stage split is held to ``stream_map``'s
stage spans and to the whole call.
"""

import dataclasses
import os
import re
import subprocess
import sys

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import port_compare as pc  # noqa: E402
from tpu_splatting import RasterConfig as JRasterConfig  # noqa: E402
from tpu_splatting.rasterizer import layout as jlay  # noqa: E402
from tpu_splatting.rasterizer import stream as jstream  # noqa: E402
from tpu_splatting.rasterizer import stream_function as jfun  # noqa: E402
from tpu_splatting.rasterizer import stream_kernels as jsk  # noqa: E402
from tpu_splatting_torch import bench as tbench  # noqa: E402
from tpu_splatting_torch.benchmarks import exp_reduce  # noqa: E402
from tpu_splatting_torch.benchmarks import profile_glue2  # noqa: E402
from tpu_splatting_torch.benchmarks import profile_map  # noqa: E402
from tpu_splatting_torch.benchmarks import profile_map2  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu", "--iters", "1", "--warmup", "0"]
SMALL = ["--n", "100", "--size", "64", "32", "--gw", "4"]
# module: its small-size arguments
MODULES = {
    "profile_map": ["--n", "2000", "--size", "128", "96"],
    "profile_map2": ["--n", "2000", "--size", "128", "96"],
    # at 300 splats the uniform scene has no wide splats, as at 2M
    "profile_reduce_map": ["--n", "300", "--size", "64", "32", "--gw", "4"],
    "profile_full": SMALL,
    "profile_full2": SMALL,
    "profile_stream": SMALL,
    "profile_stages": ["--n", "100", "--width", "64", "--height", "32"],
    "profile_glue": SMALL,
    "profile_glue2": SMALL,
    "profile_proj": ["--n", "100", "--size", "64", "32"],
    "exp_mapper": ["--n", "100", "--size", "64", "32", "--max-overlaps",
                   "8192"],
    "exp_reduce": ["--a", "2000", "--n", "300"],
    "exp_rowgather": ["--scale", "0.0005"],
    "exp_layout": ["--n", "2000"],
    "exp_precision": SMALL + ["--reps", "4"],
}
LABEL = re.compile(r'(?:benchmarked|run|raster_ms)\(\s*(f?)"([^"]*)"')


@pytest.fixture
def cal_path(tmp_path, monkeypatch):
  monkeypatch.setattr(tbench, "CAL_PATH", str(tmp_path / "cal.json"))


def reference_labels(name):
  """The labels the reference script times, as regular expressions."""
  with open(os.path.join(ROOT, "benchmarks", f"{name}.py")) as fh:
    text = fh.read()
  out = []
  for f, label in LABEL.findall(text):
    if f:
      parts = re.split(r"\{[^}]*\}", label)
      out.append(".+?".join(re.escape(p) for p in parts))
    else:
      out.append(re.escape(label))
  assert out, name
  return out


@pytest.mark.parametrize("name", sorted(MODULES))
def test_main_on_cpu_prints_the_reference_labels(name, cal_path, capsys):
  """Every label of the reference has its line; the first line is the
  device's."""
  import importlib
  mod = importlib.import_module(f"tpu_splatting_torch.benchmarks.{name}")
  assert mod.main(CPU + MODULES[name]) == 0
  lines = capsys.readouterr().out.splitlines()
  assert lines[0].startswith("device: cpu"), lines[0]
  for label in reference_labels(name):
    assert any(re.match(label + ":", line) for line in lines), (name, label)


@pytest.fixture(scope="module")
def imported_alone():
  """{module: the JAX, JAX-package and benchmarks/ modules that importing
  it brought in}, the modules imported one after another in one fresh
  process after torch."""
  code = ("import importlib, sys, torch\n"
          "bad = lambda: {m for m in sys.modules if m.split('.')[0] in "
          "('jax', 'jaxlib', 'tpu_splatting', 'benchmarks')}\n"
          "for name in sys.argv[1:]:\n"
          "  importlib.import_module('tpu_splatting_torch.benchmarks.' + "
          "name)\n"
          "  print(name, sorted(bad()))\n")
  out = subprocess.run([sys.executable, "-c", code, *sorted(MODULES)],
                       capture_output=True, text=True, check=True, cwd=ROOT)
  return dict(line.split(" ", 1) for line in out.stdout.splitlines())


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_imports_no_jax(name, imported_alone):
  assert imported_alone[name] == "[]"


@pytest.mark.parametrize("name", sorted(MODULES))
def test_main_without_a_card_raises(name):
  """The default device is the card: without one, main raises."""
  import importlib
  mod = importlib.import_module(f"tpu_splatting_torch.benchmarks.{name}")
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    mod.main([])


def distinct(depth):
  """The same depth order with no two depths in one 14-bit key (F2)."""
  n = depth.shape[0]
  rank = np.argsort(np.argsort(depth, kind="stable"), kind="stable")
  return (0.05 + 0.9 * (rank + 0.5) / n).astype(np.float32)


@pytest.fixture(scope="module")
def heavy():
  """The bench's heavy scene at 2,000 splats and 128x96 with distinct
  depths, calibrated and mapped by the port (group width 8)."""
  size = (128, 96)
  packed, depth, feats = tbench.scene_arrays("heavy", 2000, size)
  arrays = (packed, distinct(depth), feats)
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(tbench, "CAL_PATH", os.devnull + "/none")
    mp.setattr(tbench, "_cal_cached", lambda key, compute, force=False:
               compute())
    s = tbench.prepare_scene("heavy", *(torch.from_numpy(x) for x in arrays),
                             size, 8)
  return arrays, s, size


@pytest.mark.parametrize("variant", range(len(profile_map.VARIANTS)))
def test_profile_map_variant_matches_reference(heavy, variant):
  """Each variant's mapping, and its overflow by cause, against the JAX
  ``stream_map`` with the same arguments."""
  arrays, s, size = heavy
  label, kw, ok, raised = profile_map.variants(s)[variant]
  mt = profile_map.map_call(s, size, kw)(*(torch.from_numpy(x)
                                          for x in arrays))
  jcfg = JRasterConfig(compute_point_heuristic=True, compute_visibility=True,
                       stream_group_width=8,
                       big_tile_window=s.config.big_tile_window)
  mj = jstream.stream_map(*(jnp.asarray(x) for x in arrays), size, jcfg,
                          **kw)
  pc.assert_mappings_equal(mj, mt)
  np.testing.assert_array_equal(mt.overflow.numpy(), np.asarray(mj.overflow))
  assert (sum(mt.overflow.tolist()) > 0) == (label.startswith("dup")), label
  assert bool(raised) == (label == "w_max=16"), (label, raised)


def test_profile_map2_stages_split_the_call(heavy):
  """One call with tracing on enters each of ``stream_map``'s seven
  stage spans once, in order; the split names every stage, in order,
  each timed by the host clock, and the stages sum to within the call's
  ``map`` span."""
  _, s, size = heavy
  call = lambda: profile_map.map_call(s, size, s.caps)(*s.map_args)
  spans = profile_map2.traced_call(call)
  stage_spans = [span for _, span in profile_map2.STAGE_SPANS]
  assert [k for k in spans if k in stage_spans] == stage_spans
  assert all(spans[k]["calls"] == 1 for k in stage_spans)
  split = profile_map2.stage_split(call, torch.device("cpu"))
  assert list(split) == list(profile_map2.STAGES)
  assert all(st.ms > 0 and st.kernels is None for st in split.values())
  whole = spans["map"]["host_ms"]
  assert sum(spans[k]["host_ms"] for k in stage_spans) <= whole


@pytest.fixture(scope="module")
def glue_scene():
  """The uniform scene at 300 splats, 64x32 (2 groups of 4 tiles), with
  distinct depths, mapped by both packages alike."""
  size, gw = (64, 32), 4
  packed, depth, feats = tbench.scene_arrays("uniform", 300, size)
  arrays = (packed, distinct(depth), feats)
  cal = tbench.calibrate_stream(*(torch.from_numpy(x) for x in arrays), size,
                                tbench._trainer_config(gw), group_width=gw)
  caps = {**{k: cal[k] for k in tbench.MAP_KEYS}, "group_width": gw}
  return arrays, caps, cal["big_tile_window"], size, gw


def test_profile_glue2_v2_matches_reference(glue_scene):
  """v2 (K1, the loss's cotangent, K2 and the reduce) against the same
  composition of the JAX package's ``stream_forward``,
  ``stream_backward`` and ``stream_reduce``: every column within 1e-4 of
  its largest value."""
  arrays, caps, btw, size, gw = glue_scene
  tcfg = dataclasses.replace(tbench._trainer_config(gw), big_tile_window=btw)
  mt = tbench.stream_map(*(torch.from_numpy(x) for x in arrays), size, tcfg,
                         **caps)
  tgt, mask = tbench.loss_target(size, tcfg.tile_size, "cpu")
  got = profile_glue2.v2(mt, tcfg, tgt, mask).numpy()

  jcfg = JRasterConfig(compute_point_heuristic=True, compute_visibility=True,
                       stream_group_width=gw, big_tile_window=btw)
  mj = jstream.stream_map(*(jnp.asarray(x) for x in arrays), size, jcfg,
                          **caps)
  pc.assert_mappings_equal(mj, mt)
  img = jsk.stream_forward(mj, jcfg)
  err = img[:, :3, :] - jnp.asarray(tgt.numpy())
  m = jnp.asarray(mask.numpy())
  gi = jnp.concatenate([2.0 * m * err, jnp.broadcast_to(m, img[:, 3:4].shape)],
                       1)
  gout = jsk.stream_backward(mj, img, gi, jcfg, mj.run_cap)
  want = np.stack([np.asarray(c) for c in jfun.stream_reduce(
      gout, mj, mj.run_cap, jsk.slab_width(jcfg, 3))], 1)
  assert got.shape == want.shape
  tol = 1e-4 * np.abs(want).max(0) + 1e-6
  assert (np.abs(got - want) <= tol).all(), (np.abs(got - want) / tol).max(0)
  assert np.abs(want).max() > 0


@pytest.mark.parametrize("c", [1, 12])
def test_exp_reduce_matches_reference(c):
  """The port's reduce (one sort, K7 through its order) and the chain
  with a sorted copy, on dyadic rows, against the JAX
  ``segment_sum_sorted`` of the rows sorted by id: exact."""
  n = 300
  g, _, pid = exp_reduce.inputs(2000, n, c, "cpu", dyadic=True)
  order = np.argsort(pid.numpy(), kind="stable")
  ids = jnp.asarray(pid.numpy()[order])
  want = np.asarray(jlay.segment_sum_sorted(jnp.asarray(g.numpy()[order]),
                                            ids, n))
  for got in (exp_reduce.reduce_e2e(g, pid, n),
              exp_reduce.chain_full(g, pid, n)):
    np.testing.assert_array_equal(got.numpy(), want)
