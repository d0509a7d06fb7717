"""T2's and T4's launch plans and T4's chunk list, in plain Python (no
card).

``reshape_rows`` (T2) covers its rows in one launch, 512 rows a block.
``dma_residue_sum`` (T4) gives each persistent block the slabs that start
in its range of rows, in batches of at most 256 sorted by start
(``residue_plan``, ``residue_runs``), and streams the union of a batch's
rows through a ring of shared memory in chunks (``residue_chunks``, the
list the kernel builds).  Held here: the plans cover every start within
one block's shared memory; the chunks cover each batch's rows exactly
once, in order, no chunk longer than the ring's stage and no more than
``residue_plan``'s bound on their count; and a model of the kernel's
dataflow in plain torch (batches, chunks, each row's residues summed once
in the kernel's load order, copied to every slab that holds the row)
equals the twin bit for bit, on the edge inputs ``chip_smoke.py`` gives
the kernel.  The kernels themselves are held
against the twins on the card (test_torch_gpu.py, phase 8).
"""

import numpy as np
import pytest
import torch

from tpu_splatting_torch.benchmarks import exp_mosaic as em
from tpu_splatting_torch.utils.cuda_build import SMEM_LIMIT

R, ROWS = 4096, 64


def edge_starts():
  """{case: starts} of a table of R rows and slabs of ROWS rows."""
  rng = np.random.default_rng(3)
  hi = R - ROWS
  return {
      "uniform": rng.integers(0, hi + 1, 700),
      "ends": np.asarray([0, hi, 0, hi, 17, hi - 1]),
      "repeated": np.repeat(rng.integers(0, hi + 1, 40), 9),
      "all_equal": np.full(600, 1234),
      "one_slab": np.asarray([hi]),
      "sparse": rng.integers(0, hi + 1, 12),
  }


def model_residue_sum(x, s, rows, num_sms):
  """The kernel's dataflow in plain torch: block g's slabs (start in its
  range), in batches of ``T4_CAP`` by slab index, each sorted by (start,
  slab), its chunks, a chunk row's residues loaded from residue (row & 1)
  on and added in p order, then copied to every slab of the batch holding
  the row."""
  b = s.numel()
  plan = em.residue_plan(rows, x.shape[0], num_sms)
  out = torch.full((b, rows, em.RESIDUE_W), float("nan"))
  for g in range(plan.blocks):
    ids = torch.nonzero((s >= g * plan.width)
                        & (s < (g + 1) * plan.width)).flatten().tolist()
    for k in range(0, len(ids), em.T4_CAP):
      pairs = sorted((int(s[i]), i) for i in ids[k:k + em.T4_CAP])
      starts = [a for a, _ in pairs]
      chunks = em.residue_chunks(starts, rows)
      assert len(chunks) <= plan.max_chunks
      k0 = 0
      for a, n in chunks:
        res = x[a:a + n].reshape(n, em.RESIDUES, em.RESIDUE_W)
        fsum = torch.empty((n, em.RESIDUE_W))
        for j in range(n):
          odd = j & 1
          v = [res[j, (q + odd) % 8] for q in range(8)]
          acc = torch.zeros(em.RESIDUE_W)
          for r in range(8):
            acc = acc + (v[(r + 7) % 8] if odd else v[r])
          fsum[j] = acc
        while k0 < len(starts) and starts[k0] + rows <= a:
          k0 += 1
        q = k0
        while q < len(starts) and starts[q] < a + n:
          sk = starts[q]
          lo, hi = max(a, sk), min(a + n, sk + rows)
          out[pairs[q][1], lo - sk:hi - sk] = fsum[lo - a:hi - a]
          q += 1
  return out


def test_reshape_plan_covers_every_tile():
  """One launch: a warp takes two tiles of 32 rows, a block eight warps;
  (6,291,456, 16) rows in 12,288 blocks."""
  assert em.reshape_plan(6_291_456) == 12_288
  for rows in (1, 511, 512, 513, 100_000):
    blocks = em.reshape_plan(rows)
    assert blocks * 512 >= rows > (blocks - 1) * 512


@pytest.mark.parametrize("rows, r_rows", [(64, 262_144), (64, 256),
                                          (500, 4096), (1, 600)])
def test_residue_plan_covers_every_start(rows, r_rows):
  plan = em.residue_plan(rows, r_rows, 132)
  span = r_rows - rows + 1
  assert plan.blocks * plan.width >= span > (plan.blocks - 1) * plan.width
  assert plan.blocks <= 2 * 132
  assert plan.max_chunks == em.T4_CAP * (1 + -(-rows // em.T4_CHUNK_ROWS))
  assert plan.smem <= SMEM_LIMIT
  if r_rows == 262_144:                 # phase 8: two blocks an SM
    assert plan == (264, 993, 512, 110_592)
    assert 2 * (plan.smem + 1024) <= 228 * 1024


@pytest.mark.parametrize("case", sorted(edge_starts()))
def test_residue_chunks_cover_each_run_once(case):
  starts = np.sort(edge_starts()[case])
  for run in (1, 7, len(starts)):
    for g in range(0, len(starts), run):
      part = starts[g:g + run]
      chunks = em.residue_chunks(part, ROWS)
      firsts = [a for a, _ in chunks]
      assert firsts == sorted(firsts)
      assert all(0 < n <= em.T4_CHUNK_ROWS for _, n in chunks)
      got = np.concatenate([np.arange(a, a + n) for a, n in chunks])
      want = np.unique((part[:, None] + np.arange(ROWS)).reshape(-1))
      np.testing.assert_array_equal(got, want)      # once each, in order
      assert len(chunks) <= len(part) * (1 + ROWS // em.T4_CHUNK_ROWS)


def test_residue_rows_read_counts_boundary_rows():
  """Each batch reads its union once, so a row two blocks' ranges share
  counts twice; a crowded range goes in batches of ``T4_CAP``."""
  s = torch.from_numpy(edge_starts()["uniform"].astype(np.int32))
  needed = np.unique((s.numpy()[:, None] + np.arange(ROWS)).reshape(-1)).size
  plan = em.residue_plan(ROWS, R, 2)
  runs = em.residue_runs(s, ROWS, R, 2)
  assert len(runs) == plan.blocks == 4
  assert sorted(sum(runs, [])) == sorted(s.tolist())
  for g, (lo, hi) in enumerate(zip(runs, runs[1:])):
    assert max(lo) < (g + 1) * plan.width <= min(hi)
  read = sum(np.unique((np.asarray(r)[:, None] + np.arange(ROWS))
                       .reshape(-1)).size for r in runs)
  assert em.residue_rows_read(s, ROWS, R, 2) == read
  assert needed < read <= needed + 3 * (ROWS - 1)
  crowded = torch.full((700,), 1234, dtype=torch.int32)
  assert [len(r) for r in em.residue_runs(crowded, ROWS, R, 132)] == [
      256, 256, 188]


@pytest.mark.parametrize("case", sorted(edge_starts()))
@pytest.mark.parametrize("num_sms", [1, 132])
def test_ring_model_equals_twin(case, num_sms):
  x = torch.from_numpy(np.random.default_rng(5).standard_normal(
      (R, em.RESIDUES * em.RESIDUE_W)).astype(np.float32))
  s = torch.from_numpy(edge_starts()[case].astype(np.int32))
  want = em.dma_residue_sum_reference(x, s, ROWS)
  assert torch.equal(model_residue_sum(x, s, ROWS, num_sms), want)


def test_ring_model_at_other_slab_heights():
  """Slabs taller than a ring stage (several chunks a slab) and shorter."""
  x = torch.from_numpy(np.random.default_rng(6).standard_normal(
      (600, 128)).astype(np.float32))
  for rows in (1, 100, 500):
    s = torch.from_numpy(np.random.default_rng(rows).integers(
        0, 600 - rows + 1, 30).astype(np.int32))
    assert torch.equal(model_residue_sum(x, s, rows, 4),
                       em.dma_residue_sum_reference(x, s, rows))
