"""Port vs reference: the data-movement kernels' plain twins.

``window_copy_reference`` (K6) against the JAX ``window_copy`` exactly,
and ``segment_sum_sorted_reference`` (K7) against the JAX
``segment_sum_sorted`` (interpret mode: exact sums) to 1e-6, on the
cases of tests/test_layout.py: empty windows, full windows, sentinel
ids, one heavy id.  The port's K7 takes any column count and int32 ids;
the reference takes at most 15 columns.  The kernels themselves are held
against these twins in test_torch_gpu.py and chip_smoke.py.
"""

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from tpu_splatting.rasterizer import layout as jlay  # noqa: E402
from tpu_splatting_torch.rasterizer import layout as tlay  # noqa: E402


def window_case(seed, dtype=np.float32, c=5):
  rng = np.random.default_rng(seed)
  g, p, k = 8, 256, 17
  rows = rng.standard_normal((p + g, c)).astype(dtype)
  src = rng.integers(0, p, k).astype(np.int32)
  cnt = rng.integers(0, g + 1, k).astype(np.int32)
  cnt[3] = 0
  cnt[5] = g
  return rows, src, cnt, g


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_window_copy_matches_reference(seed, dtype):
  rows, src, cnt, g = window_case(seed, dtype)
  want = np.asarray(jlay.window_copy(jnp.asarray(rows), jnp.asarray(src),
                                     jnp.asarray(cnt), g))
  got = tlay.window_copy(torch.from_numpy(rows), torch.from_numpy(src),
                         torch.from_numpy(cnt), g)
  assert got.dtype == torch.from_numpy(rows).dtype
  np.testing.assert_array_equal(got.numpy(), want)


def test_window_copy_int32_ids():
  """The port copies int32 point ids as they are (the reference carries
  them by value in f32, exact below 2^24)."""
  rows, src, cnt, g = window_case(7, c=1)
  ids = (np.arange(rows.shape[0]) * 7919 % 100_003).astype(np.int32)
  want = np.asarray(jlay.window_copy(
      jnp.asarray(ids.astype(np.float32)[:, None]), jnp.asarray(src),
      jnp.asarray(cnt), g))[:, 0].astype(np.int32)
  got = tlay.window_copy(torch.from_numpy(ids), torch.from_numpy(src),
                         torch.from_numpy(cnt), g)
  assert got.dtype == torch.int32 and got.shape == (17 * g,)
  np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("n", [64, 300])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_segment_sum_sorted_matches_reference(seed, n, dtype):
  rng = np.random.default_rng(seed + 10)
  m, c = 1000, 6
  ids = np.sort(rng.integers(0, n, m)).astype(np.int32)
  ids[-50:] = n + rng.integers(0, 5, 50)     # sentinel tail
  ids = np.sort(ids)
  rows = rng.standard_normal((m, c)).astype(dtype)
  want = np.asarray(jlay.segment_sum_sorted(jnp.asarray(rows),
                                            jnp.asarray(ids), n, block=64,
                                            sub=128))
  got = tlay.segment_sum_sorted(torch.from_numpy(rows),
                                torch.from_numpy(ids), n)
  assert got.shape == (n, c) and got.dtype == torch.from_numpy(rows).dtype
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_segment_sum_sorted_empty_and_heavy():
  """One id owning most rows; many empty ids."""
  m, c, n = 512, 3, 100
  ids = np.full(m, 7, np.int32)
  ids[-10:] = 99
  rows = np.ones((m, c), np.float32)
  want = np.asarray(jlay.segment_sum_sorted(jnp.asarray(rows),
                                            jnp.asarray(ids), n, block=32,
                                            sub=64))
  got = tlay.segment_sum_sorted(torch.from_numpy(rows),
                                torch.from_numpy(ids), n)
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
  assert float(got[7, 0]) == m - 10 and float(got[99, 0]) == 10


def test_segment_sum_sorted_wide_rows():
  """More columns than the reference's packed limit of 15: the port sums
  them in one call, equal to the reference's 15-column groups."""
  rng = np.random.default_rng(3)
  m, c, n = 700, 21, 90
  ids = np.sort(rng.integers(0, n + 3, m)).astype(np.int32)
  rows = rng.standard_normal((m, c)).astype(np.float32)
  want = np.concatenate([np.asarray(jlay.segment_sum_sorted(
      jnp.asarray(rows[:, lo:lo + 15]), jnp.asarray(ids), n))
      for lo in (0, 15)], -1)
  got = tlay.segment_sum_sorted(torch.from_numpy(rows),
                                torch.from_numpy(ids), n)
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k, g, c, m, ok", [
    (54_028, 128, 1, 5_342_976, True),       # full-size overlap ids
    (54_028, 128, 12, 5_342_976, True),      # full-size gradient rows
    ((2 ** 31 - 1) // 128, 128, 1, 10, True),
    (2 ** 24, 128, 1, 10, False),            # 2^31 output elements
    (10, 128, 12, 2 ** 31 // 12 + 1, False),  # rows past 2^31 elements
])
def test_window_copy_range_guard(k, g, c, m, ok):
  """The CUDA window copy indexes in 32 bits; its wrapper raises on
  shapes past 2^31 elements rather than wrapping around."""
  if ok:
    tlay.check_window_copy_range(k, g, c, m)
  else:
    with pytest.raises(ValueError, match="32-bit"):
      tlay.check_window_copy_range(k, g, c, m)
