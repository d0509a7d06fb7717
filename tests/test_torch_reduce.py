"""Port vs reference: the sorted pipeline's gradient and visibility reduce.

* ``segment_sum_sorted(rows, ids, n, order=order)`` (K7 reading its rows
  through the sort's permutation) against the JAX ``segment_sum_sorted``
  (interpret mode: exact sums) on the same rows gathered by ``order``, at
  1, 6, 12 and 21 columns (the reference takes at most 15: 21 goes to it
  in two groups), f32 and f64, with empty segments, one heavy segment and
  a sentinel tail; to 1e-6.
* ``reduce_chunked_to_points`` against the reference's
  (``tpu_splatting/rasterizer/function.py``), which sorts the rows as
  payload, on the same per-slot rows and point ids; to 1e-6.
* The point-id sort runs at most once per ``rasterize_with_tiles`` call
  (both reduces share it) and not at all where neither reduce runs.
* ``row_gather``'s twin against the oracle of ``benchmarks/exp_gather.py``
  (numpy indexing), with 0 where an index lies outside the table, as
  ``make_pallas_gather`` masks it.  The probe's Pallas kernels cannot run
  here: on the CPU ``pl.pallas_call`` needs ``interpret=True``, which the
  probe does not pass, and under ``pltpu.force_tpu_interpret_mode()`` JAX
  0.9 rejects their advanced indexers ("Advanced indexers are not
  supported on TPU").

The CUDA kernels are held against these twins, and the fused call
against the unfused one bit for bit, in test_torch_gpu.py and
chip_smoke.py.
"""

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from tpu_splatting.rasterizer import function as jfn  # noqa: E402
from tpu_splatting.rasterizer import layout as jlay  # noqa: E402
from tpu_splatting_torch import RasterConfig, map_to_tiles  # noqa: E402
from tpu_splatting_torch.rasterizer import function as tfn  # noqa: E402
from tpu_splatting_torch.rasterizer import layout as tlay  # noqa: E402
from tpu_splatting_torch.scenes import uniform_scene  # noqa: E402


def slot_ids(case, m, n, rng):
  """(m,) unsorted point ids of chunk slots, null slots (id n) included."""
  if case == "uniform":
    pid = rng.integers(0, n, m)
  elif case == "heavy":               # one id owns most slots
    pid = np.where(rng.random(m) < 0.8, 7, rng.integers(0, n, m))
  else:                               # "sparse": most ids have no slot
    pid = rng.choice([0, 3, n // 2, n - 1], m)
  pid[rng.random(m) < 0.3] = n        # the null slots, sorted last
  return pid.astype(np.int32)


def reference_sum(rows_sorted, ids, n):
  """The JAX segment sum, in 15-column groups (its packed limit)."""
  c = rows_sorted.shape[1]
  return np.concatenate([np.asarray(jlay.segment_sum_sorted(
      jnp.asarray(rows_sorted[:, lo:lo + 15]), jnp.asarray(ids), n,
      block=64, sub=128)) for lo in range(0, c, 15)], -1)


@pytest.mark.parametrize("case", ["uniform", "heavy", "sparse"])
@pytest.mark.parametrize("c", [1, 6, 12, 21])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_segment_sum_sorted_order_matches_reference(case, c, dtype):
  rng = np.random.default_rng(c)
  m, n = 900, 200
  pid = slot_ids(case, m, n, rng)
  order = np.argsort(pid, kind="stable")
  ids = pid[order]
  rows = rng.standard_normal((m, c)).astype(dtype)
  if dtype == np.float32:
    # multiples of 2^-8 below 2^4: every sum of the heavy segment's ~700
    # rows is exact in f32, whatever order the reference's one-hot blocks
    # add them in, so 1e-6 checks which rows each segment sums
    rows = np.round(rows * 256) / 256
  want = reference_sum(rows[order], ids, n)
  got = tlay.segment_sum_sorted(torch.from_numpy(rows), torch.from_numpy(ids),
                                n, order=torch.from_numpy(order))
  assert got.shape == (n, c) and got.dtype == torch.from_numpy(rows).dtype
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
  # the unfused call on rows[order] gives the same sums
  unfused = tlay.segment_sum_sorted(torch.from_numpy(rows[order]),
                                    torch.from_numpy(ids), n)
  assert torch.equal(unfused, got)


@pytest.mark.parametrize("c", [12, 1])
@pytest.mark.parametrize("seed", range(2))
def test_reduce_chunked_to_points_matches_reference(c, seed):
  """The port sorts the ids alone and gathers in the segment sum; the
  reference sorts the rows as payload of the ids."""
  rng = np.random.default_rng(seed + 40)
  m, n = 1280, 300
  pid = slot_ids("uniform", m, n, rng)
  x = rng.standard_normal((m, c)).astype(np.float32)
  want = np.asarray(jfn.reduce_chunked_to_points(jnp.asarray(x),
                                                 jnp.asarray(pid), n))
  tfn.sort_counts["point_ids"] = 0
  by_point = tfn.sort_point_ids(torch.from_numpy(pid))
  assert by_point.order.dtype == torch.int64
  got = tfn.reduce_chunked_to_points(torch.from_numpy(x), by_point, n)
  assert got.shape == (n, c)
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
  # a second reduce through the same order sorts nothing
  again = tfn.reduce_chunked_to_points(torch.from_numpy(x), by_point, n)
  assert tfn.sort_counts["point_ids"] == 1
  assert torch.equal(again, got)


@pytest.mark.parametrize("visibility, grad, sorts", [
    (True, True, 1), (False, True, 1), (True, False, 1), (False, False, 0)])
def test_point_ids_sorted_once_per_call(visibility, grad, sorts):
  """The visibility reduce and the backward share one sort of the point
  ids; a render that needs neither does not sort them."""
  size = (64, 48)
  packed, depth, feats = (torch.from_numpy(a) for a in uniform_scene(
      np.random.default_rng(3), 300, size))
  config = RasterConfig(pipeline="sorted", compute_visibility=visibility)
  m = map_to_tiles(packed, depth, size, config, max_overlaps=20_000,
                   features=feats)
  g2d = packed.clone().requires_grad_(grad)
  tfn.sort_counts["point_ids"] = 0
  out = tfn.rasterize_with_tiles(g2d, feats, m, size, config)
  if grad:
    out.image.square().sum().backward()
    assert bool(torch.isfinite(g2d.grad).all())
  assert tfn.sort_counts["point_ids"] == sorts
  assert (out.visibility is not None) == visibility


@pytest.mark.parametrize("shape, idx_dtype", [
    ((1000, 16), np.int32), ((1000, 16), np.int64), ((1000, 3), np.int32),
    ((1000,), np.int32)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
def test_row_gather_matches_probe_oracle(shape, idx_dtype, dtype):
  """The probe's index distribution (rng.integers(0, n, a)), plus indices
  outside the table, which come out 0."""
  rng = np.random.default_rng(0)
  n, a = shape[0], 4096
  table = (rng.random(shape) * 1000).astype(dtype)
  idx = rng.integers(0, n, a)
  out_of_range = rng.random(a) < 0.05
  idx[out_of_range] = rng.choice([-1, -n, n, n + 7], int(out_of_range.sum()))
  idx = idx.astype(idx_dtype)
  want = table[np.clip(idx, 0, n - 1)]
  want[out_of_range] = 0
  tlay.reset_launch_counts()
  got = tlay.row_gather(torch.from_numpy(table), torch.from_numpy(idx))
  assert got.dtype == torch.from_numpy(table).dtype
  np.testing.assert_array_equal(got.numpy(), want)
  assert tlay.probe_launch_counts["row_gather"] == 0   # the twin ran


def test_row_gather_empty_table():
  got = tlay.row_gather(torch.zeros((0, 4)), torch.tensor([0, -1, 3]))
  assert torch.equal(got, torch.zeros((3, 4)))


def test_second_backward_sorts_again():
  """The backward frees the shared order after its last use; a second
  backward through a retained graph sorts the ids again and gives the
  same gradient."""
  size = (64, 48)
  packed, depth, feats = (torch.from_numpy(a) for a in uniform_scene(
      np.random.default_rng(4), 300, size))
  config = RasterConfig(pipeline="sorted", compute_visibility=True)
  m = map_to_tiles(packed, depth, size, config, max_overlaps=20_000,
                   features=feats)
  g2d = packed.clone().requires_grad_(True)
  tfn.sort_counts["point_ids"] = 0
  loss = tfn.rasterize_with_tiles(g2d, feats, m, size, config).image.sum()
  (first,) = torch.autograd.grad(loss, g2d, retain_graph=True)
  (second,) = torch.autograd.grad(loss, g2d)
  assert tfn.sort_counts["point_ids"] == 2
  assert torch.equal(first, second)
