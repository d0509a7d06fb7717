"""The port's bench as a program (``tpu_splatting_torch.bench`` and
``tpu_splatting_torch.benchmarks``), on the CPU: no reference runs here
(tests/test_torch_bench.py and test_torch_bench_full.py hold its
functions to the JAX package).

* The calibration cache: the versioned key, a hit, an overflowing entry
  or one of other capacity semantics computed again, the repository's
  ``.bench_cal.json`` untouched.
* ``main`` prints the card line and the reference's keys and exits 0, and
  exits 1, with each failed scene under ``errors`` and no fallback, when
  a scene's mapping drops rows; ``prewarm_cal`` fills the same cache.
* Every entry point raises without a card unless ``--device cpu``; each
  companion's CPU path at a small size.
* No module of the port (nor ``chip_smoke.py``) imports ``jax``,
  ``tpu_splatting``, ``bench`` or ``benchmarks``.
"""

import ast
import glob
import json
import os

import numpy as np
import pytest
import torch

from tpu_splatting_torch import bench as tbench
from tpu_splatting_torch.benchmarks import (bench_4k, bench_components,
                                            bench_stream, check_card,
                                            prewarm_cal)
from tpu_splatting_torch.rasterizer.stream import CAPACITY_SEMANTICS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def cache_in_tmp(tmp_path, monkeypatch):
  """Every test's calibration cache lies in its temporary directory."""
  monkeypatch.setattr(tbench, "CAL_PATH", str(tmp_path / "bench_cal.json"))


def test_calibration_cache():
  """The key carries CAPACITY_SEMANTICS; a second call is a hit; an entry
  that recorded overflow, or of other semantics, is computed again; the
  repository's .bench_cal.json is neither read nor written."""
  root = os.path.join(REPO, ".bench_cal.json")
  with open(root, "rb") as fh:
    before = fh.read()
  calls = []

  def compute():
    calls.append(1)
    return {"num_slabs": 2, "slab_cap": 512, "overflow": [0] * 5}

  key = f"heavy_gw8_v{CAPACITY_SEMANTICS}"
  entry = tbench._cal_cached("heavy_gw8", compute)
  with open(tbench.CAL_PATH) as fh:
    assert list(json.load(fh)) == [key]
  assert tbench._cal_cached("heavy_gw8", compute) == entry
  assert len(calls) == 1

  for stale in ({key: {**entry, "overflow": [0, 0, 1, 0, 0]}},
                {f"heavy_gw8_v{CAPACITY_SEMANTICS - 1}": entry}):
    with open(tbench.CAL_PATH, "w") as fh:
      json.dump(stale, fh)
    assert tbench._cal_cached("heavy_gw8", compute) == entry
  assert len(calls) == 3
  with open(tbench.CAL_PATH) as fh:
    assert json.load(fh)[key]["overflow"] == [0] * 5

  # a scene's calibration through the cache: keyed by its sizes
  arrays = (torch.from_numpy(x) for x in
            tbench.scene_arrays("heavy", 300, (64, 48)))
  cal = tbench.calibrate_scene("heavy", *arrays, (64, 48), 4)
  with open(tbench.CAL_PATH) as fh:
    assert json.load(fh)[f"heavy_gw4_n300_64x48_v{CAPACITY_SEMANTICS}"] == cal
  with open(root, "rb") as fh:
    assert fh.read() == before


def test_main_on_the_cpu(capsys):
  """The card line, then one JSON line with the reference's keys (no
  stream_passes, no errors), exit 0; prewarm_cal then finds every entry
  in the cache."""
  argv = ["--device", "cpu", "--n", "300", "--size", "128", "96"]
  assert tbench.main(argv) == 0
  lines = capsys.readouterr().out.strip().splitlines()
  assert lines[0].startswith("device: cpu")
  out = json.loads(lines[-1])
  for k in ("metric", "value", "unit", "group_width", "uniform_map_ms",
            "uniform_raster_ms", "uniform_ms", "heavy_map_ms",
            "heavy_raster_ms", "heavy_ms", "uniform_full_ms", "vs_baseline"):
    assert k in out, k
  assert "errors" not in out and "stream_passes" not in out
  assert not [k for k in out if k.endswith("_cal")], out
  assert out["value"] == out["uniform_full_ms"] > 0
  assert out["uniform_ms"] == out["uniform_map_ms"] + out["uniform_raster_ms"]
  with open(tbench.CAL_PATH) as fh:
    keys = set(json.load(fh))
  assert len(keys) == 3, keys
  assert prewarm_cal.main(argv) == 0
  with open(tbench.CAL_PATH) as fh:
    assert set(json.load(fh)) == keys
  assert "calibration cache hit" in capsys.readouterr().err


def test_main_exits_nonzero_when_a_scene_fails(capsys, monkeypatch):
  """A calibration too small for its scene: every scene's mapping drops
  rows (also after the forced recalibration), each gets its errors entry,
  the headline has no fallback, and main returns 1."""
  real = tbench.calibrate_stream

  def too_small(*args, **kw):
    return {**real(*args, **kw), "num_slabs": 1, "slab_cap": 8}
  monkeypatch.setattr(tbench, "calibrate_stream", too_small)
  assert tbench.main(["--device", "cpu", "--n", "300", "--size", "128",
                      "96"]) == 1
  out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  assert set(out["errors"]) == {"uniform", "heavy", "uniform_full"}
  assert "rows dropped" in out["errors"]["heavy"]
  assert out["value"] == -1 and out["vs_baseline"] == 0.0


@pytest.mark.parametrize("module", [tbench, bench_4k, bench_components,
                                    bench_stream, prewarm_cal, check_card])
def test_entry_points_raise_without_a_card(module):
  if torch.cuda.is_available():
    pytest.skip("checks the behaviour where CUDA is absent")
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    module.main([])


def test_companions_on_the_cpu():
  """Each companion's CPU path at a small size: the component benches
  (an overlap capacity that drops overlaps raises), bench_stream's
  calls, bench_4k's depth12 guard, check_card's comparison."""
  assert bench_components.bench_projection(n=2000, iters=1,
                                           device="cpu") > 0
  assert bench_components.bench_sh(n=2000, iters=1, device="cpu") > 0
  assert bench_components.bench_tilemapper(
      n=500, image_size=(64, 48), iters=1, max_overlaps=4096,
      device="cpu") > 0
  assert bench_components.bench_rasterizer(
      n=200, image_size=(32, 32), iters=1, backward=True, chunk_size=16,
      device="cpu") > 0
  with pytest.raises(RuntimeError, match="overlaps dropped"):
    bench_components.rasterizer_setup(n=200, image_size=(32, 32),
                                      max_overlaps=64, chunk_size=16,
                                      device="cpu")

  s = bench_stream.setup(n=500, image_size=(64, 48), scale=1.0,
                         device="cpu")
  assert set(bench_stream.run(s, iters=1)) == {
      "stream_map", "stream_forward", "stream_fwd_bwd", "bwd_kernel_only",
      "reduce_only", "stream_e2e_map_fwd_bwd"}

  with pytest.raises(RuntimeError, match="depth_bits 14"):
    bench_4k.prepare("cpu", n=200, image_size=(128, 96))

  size = (64, 48)
  scene = check_card.make_scene(600, size, n_culled=8, n_dim=8, n_wide=4)
  cfg = tbench._trainer_config(2)
  caps = dict(num_slabs=2, strip_cap=512, slab_cap=256, w_max=40,
              run_cap=128, wide_cap=64, dup_cap=2048)
  assert check_card.check("tiny", *scene, size, cfg, caps, 2, "cpu",
                          n_zero_grad=16)
  assert check_card.compare("perturbed", np.ones(4), np.zeros(4), 1e-3,
                            1e-3) is False


def test_port_imports_no_reference():
  """No module of the port and not chip_smoke.py imports jax, the JAX
  package, the repository's bench.py or its benchmarks/ (the port's own
  ``from .. import bench`` is relative and allowed)."""
  paths = glob.glob(os.path.join(REPO, "tpu_splatting_torch", "**", "*.py"),
                    recursive=True) + [os.path.join(REPO, "chip_smoke.py")]
  assert len(paths) > 40
  banned = {"jax", "jaxlib", "tpu_splatting", "bench", "benchmarks"}
  for path in paths:
    with open(path) as fh:
      tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
      if isinstance(node, ast.Import):
        names = [a.name for a in node.names]
      elif isinstance(node, ast.ImportFrom) and node.level == 0:
        names = [node.module]
      else:
        continue
      for name in names:
        assert name.split(".")[0] not in banned, (path, name)


@pytest.mark.parametrize("flag", ["--profile-fwd", "--profile-bwd"])
def test_bench_stream_profiles_refuse_the_cpu(flag):
  """The profiles read device time: ``--device cpu`` refuses them."""
  with pytest.raises(SystemExit, match="need the card"):
    bench_stream.main([flag, "--device", "cpu", "--n", "300"])


def test_bench_stream_counts_on_the_cpu(capsys):
  """The profiles' first lines, K1's counts of the mapping, from the
  twin on a small CPU scene."""
  s = bench_stream.setup(n=500, image_size=(64, 48), scale=1.0,
                         device="cpu")
  counts = bench_stream.active_counts(s)
  out = capsys.readouterr().out
  assert f"# ACTIVE SLAB ITERS: {counts['iterations']} (tiles " in out
  assert "walked (row, warp) pairs" in out
  assert s.mapping.num_tiles <= counts["iterations"] <= (
      s.mapping.num_tiles * s.mapping.num_slabs)
  assert 0.0 < counts["walked_share"] <= 1.0
  assert counts["pairs"] <= counts["rows"] * 8
