"""The stream mapper's descriptor kernel without a card.

``stream_kernels.stream_descriptors`` checks its inputs and plans its
launch before it looks at the device, so tensors on the ``meta`` device
(real shapes and types, no data) reach every check here; a valid call on
``meta`` then stops at the device.  CPU tensors take the plain twin,
``stream.stream_descriptors_reference``.  The kernel itself is held to the
twin bit for bit by the ``gpu`` tests.
"""

import numpy as np
import pytest
import torch

from tpu_splatting_torch import RasterConfig
from tpu_splatting_torch.rasterizer import stream as st
from tpu_splatting_torch.rasterizer import stream_kernels as sk
from tpu_splatting_torch.scenes import heavy_scene
from tpu_splatting_torch.utils.cuda_build import SMEM_LIMIT

# the heavy 2M mapping's shapes (2048x1536, tile 16, its calibration)
HEAVY = dict(tiles_wide=128, tiles_high=96, group_width=8, num_slabs=32,
             strip_cap=1 << 20, slab_cap=1792, w_max=57, run_cap=2048,
             rows_per_block=4)


def inputs(kw, edges_dtype=torch.int64, groups=None):
  tw, th, gw, s = (kw[k] for k in ("tiles_wide", "tiles_high", "group_width",
                                   "num_slabs"))
  edges = torch.empty((tw * th * 16 * s + 1,), dtype=edges_dtype,
                      device="meta")
  blk = torch.empty((groups or th * (tw // gw), 3), dtype=torch.int64,
                    device="meta")
  return edges, blk


# case: (inputs' variation, arguments' variation, the ValueError's words)
CHECKS = {
    "edges_int32": (dict(edges_dtype=torch.int32), {}, "contiguous int64"),
    "strip_blk_shape": (dict(groups=7), {}, "strip_blk must be"),
    "rows_per_block": ({}, dict(rows_per_block=3), "rows_per_block 3"),
    "strip_cap_past_int32": ({}, dict(strip_cap=1 << 30), "below 2"),
    "groups_do_not_divide": ({}, dict(group_width=6), "group width 6"),
    "shared_memory": ({}, dict(group_width=64, num_slabs=32, w_max=72),
                      r"needs \d+ B of shared memory a block"),
    "device": ({}, {}, "unsupported device meta"),
}


@pytest.mark.parametrize("case", sorted(CHECKS))
def test_stream_descriptors_checks_its_inputs(case):
  make, over, words = CHECKS[case]
  kw = {**HEAVY, **over}
  edges, blk = inputs(kw, **make)
  sk.reset_launch_counts()
  with pytest.raises(ValueError, match=words):
    sk.stream_descriptors(edges, blk, **kw)
  assert sk.launch_counts["stream_descriptors"] == 0


def test_stream_descriptors_plan():
  """A warp a tile, at most 8; per warp a row of w_max int4, S int64
  counts and S + 1 plan ints; three band strips of (gw + 2) * 16 * S + 1
  int32 edges."""
  plan = sk.stream_descriptors_plan(8, 32, 57)
  assert (plan.threads, plan.smem) == (256, 8 * (16 * 57 + 8 * 32 + 4 * 33)
                                       + 12 * (10 * 16 * 32 + 1))
  assert plan.smem == 71852
  assert sk.stream_descriptors_plan(40, 1, 8).threads == 256
  assert sk.stream_descriptors_plan(2, 2, 64).threads == 64
  assert sk.stream_descriptors_plan(16, 32, 72).smem <= SMEM_LIMIT
  assert sk.stream_descriptors_plan(40, 32, 72).smem > SMEM_LIMIT


def test_stream_map_on_the_cpu_takes_the_twin(monkeypatch):
  """A CPU mapping's descriptors come from the twin's pipeline, through
  the wrapper, and launch nothing."""
  from tpu_splatting_torch.benchmarks.bench_descriptors import recorded_calls
  pipelines = []
  pipeline = st._desc_pipeline

  def counted(*args, **kw):
    pipelines.append(1)
    return pipeline(*args, **kw)
  monkeypatch.setattr(st, "_desc_pipeline", counted)
  size = (128, 96)
  packed, depth, feats = (torch.from_numpy(x) for x in heavy_scene(
      np.random.default_rng(1), 2000, size))
  sk.reset_launch_counts()
  with recorded_calls() as calls:
    m = st.stream_map(packed, depth, feats, size, RasterConfig(),
                      num_slabs=3, strip_cap=2048, slab_cap=256, w_max=24,
                      run_cap=128, wide_cap=256, dup_cap=4096)
  assert len(calls) == 1 and pipelines
  assert sk.launch_counts["stream_descriptors"] == 0
  edges_all, strip_blk, kw, (desc, over) = calls[0]
  assert desc.dtype == torch.int32 and torch.equal(m.desc, desc)
  want_desc, want_over = st.stream_descriptors_reference(edges_all,
                                                         strip_blk, **kw)
  assert torch.equal(desc, want_desc) and torch.equal(over, want_over)
  assert int((desc.view(-1, 4)[:, 1] > 0).sum()) > 0


def test_bench_descriptors_script_on_the_cpu(tmp_path, monkeypatch, capsys):
  """``benchmarks.bench_descriptors`` at a small heavy scene on the CPU:
  a line for the kernel's wrapper (the twin on the CPU) and the twin, and
  their outputs equal."""
  from tpu_splatting_torch import bench
  from tpu_splatting_torch.benchmarks import bench_descriptors
  monkeypatch.setattr(bench, "CAL_PATH", str(tmp_path / "cal.json"))
  assert bench_descriptors.main(
      ["--device", "cpu", "--iters", "1", "--warmup", "0", "--n", "2000",
       "--size", "128", "96"]) == 0
  out = capsys.readouterr().out
  for label in ("descriptors kernel: ", "descriptors twin: ",
                "kernel equals twin: True"):
    assert label in out, out
