"""Port vs reference: ``misc.morton`` and ``misc.indexing``.

Morton codes (30- and 60-bit) and the Morton permutation must be equal
exactly, duplicate points and points on bin edges included;
``index_features`` and its gradient equal ``jax.grad``;
``segmented_sort_pairs`` equals the reference's two-key ``lax.sort``,
ties included.
"""

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from tpu_splatting.misc import indexing as jidx  # noqa: E402
from tpu_splatting.misc import morton as jm  # noqa: E402
from tpu_splatting_torch.misc import indexing as tidx  # noqa: E402
from tpu_splatting_torch.misc import morton as tm  # noqa: E402


def points(kind, n=2000, seed=0):
  """(n, 3) f32 points: uniform, clustered normal, with duplicates, or on
  the 10- and 20-bit bin edges of the unit cube."""
  rng = np.random.default_rng(seed)
  if kind == "uniform":
    return rng.random((n, 3)).astype(np.float32)
  if kind == "normal":
    return (rng.normal(0.0, 1.2, (n, 3)) * [1.0, 0.1, 3.0]).astype(np.float32)
  if kind == "duplicates":
    base = rng.random((n // 8, 3)).astype(np.float32)
    return base[rng.integers(0, n // 8, n)]
  if kind == "bin_edges":
    k10 = rng.integers(0, 1024, (n // 2, 3)) / 1023.0
    k20 = rng.integers(0, 1 << 20, (n - n // 2, 3)) / float((1 << 20) - 1)
    p = np.concatenate([k10, k20]).astype(np.float32)
    p[0], p[1] = 0.0, 1.0          # the bounds are the unit cube
    return p
  raise ValueError(kind)


KINDS = ["uniform", "normal", "duplicates", "bin_edges"]


def test_spread_bits_exhaustive():
  x = np.arange(1 << 12, dtype=np.uint32)     # bits above 10 are dropped
  want = np.asarray(jm._spread_bits_10(jnp.asarray(x))).astype(np.int64)
  got = tm._spread_bits_10(torch.from_numpy(x.astype(np.int64)))
  assert got.dtype == torch.int64
  np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", KINDS)
def test_morton_codes_equal(kind):
  p = points(kind)
  pj, pt = jnp.asarray(p), torch.from_numpy(p)
  a, b = np.asarray(jm.morton_codes(pj)), tm.morton_codes(pt)
  assert b.dtype == torch.int32 and a.dtype == np.int32
  np.testing.assert_array_equal(b.numpy(), a)
  (hj, lj), (ht, lt) = jm.morton_codes_60(pj), tm.morton_codes_60(pt)
  assert ht.dtype == lt.dtype == torch.int32
  np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
  np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
  for bits in (10, 20):
    lo, hi = p.min(0), p.max(0)
    want = np.asarray(jm.grid_coords(pj, jnp.asarray(lo), jnp.asarray(hi),
                                     bits=bits)).astype(np.int64)
    got = tm.grid_coords(pt, torch.from_numpy(lo), torch.from_numpy(hi),
                         bits=bits)
    np.testing.assert_array_equal(got.numpy(), want, err_msg=str(bits))


def test_morton_codes_explicit_bounds():
  """Bounds given by the caller (points outside them clip to the grid's
  edges), and a degenerate axis (upper == lower: the 1e-12 floor)."""
  p = points("normal", n=500, seed=4)
  p[:, 1] = 0.25
  lower, upper = np.float32([-1.0, 0.25, -2.0]), np.float32([1.0, 0.25, 2.0])
  want = jm.morton_codes(jnp.asarray(p), jnp.asarray(lower),
                         jnp.asarray(upper))
  got = tm.morton_codes(torch.from_numpy(p), torch.from_numpy(lower),
                        torch.from_numpy(upper))
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  hj, lj = jm.morton_codes_60(jnp.asarray(p), lower, upper)
  ht, lt = tm.morton_codes_60(torch.from_numpy(p), lower, upper)
  np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
  np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))


@pytest.mark.parametrize("kind", KINDS)
def test_argsort_morton_equal(kind):
  """The permutation exactly, ties (equal 60-bit codes) included."""
  p = points(kind, seed=1)
  want = np.asarray(jm.argsort_morton(jnp.asarray(p)))
  got = tm.argsort_morton(torch.from_numpy(p))
  assert got.dtype == torch.int64
  np.testing.assert_array_equal(got.numpy(), want)
  if kind == "duplicates":
    hi, lo = tm.morton_codes_60(torch.from_numpy(p))
    key = (hi.long() << 30) | lo.long()
    assert torch.unique(key).numel() < len(p)     # ties were there


def test_sort_by_morton_with_companions():
  p = points("uniform", n=300, seed=2)
  extra = np.arange(300 * 2, dtype=np.float32).reshape(300, 2)
  want = jm.sort_by_morton(jnp.asarray(p), jnp.asarray(extra))
  got = tm.sort_by_morton(torch.from_numpy(p), torch.from_numpy(extra))
  for a, b in zip(got, want):
    np.testing.assert_array_equal(a.numpy(), np.asarray(b))
  alone = tm.sort_by_morton(torch.from_numpy(p))
  np.testing.assert_array_equal(alone.numpy(), np.asarray(want[0]))


def test_morton_locality():
  """``tests/test_io_morton.py``'s locality check on the port."""
  rng = np.random.default_rng(0)
  pts = torch.from_numpy(rng.random((2000, 3)).astype(np.float32))
  codes = tm.morton_codes(pts)
  assert int(codes.min()) >= 0
  perm = tm.argsort_morton(pts)
  assert sorted(perm.tolist()) == list(range(2000))
  p = pts.numpy()
  d_sorted = np.linalg.norm(np.diff(p[perm.numpy()], axis=0), axis=1).mean()
  d_random = np.linalg.norm(np.diff(p, axis=0), axis=1).mean()
  assert d_sorted < d_random * 0.35


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_index_features_and_gradient(dtype):
  """The gather and its gradient (a scatter-add, duplicates summed)
  against ``jax.grad``."""
  rng = np.random.default_rng(3)
  feats = rng.standard_normal((50, 6)).astype(dtype)
  idx = rng.integers(0, 50, 200)
  weight = rng.standard_normal((200, 6)).astype(dtype)

  def loss_j(f):
    return jnp.sum(jidx.index_features(f, jnp.asarray(idx))
                   * jnp.asarray(weight))
  want_out = np.asarray(jidx.index_features(jnp.asarray(feats),
                                            jnp.asarray(idx)))
  want_grad = np.asarray(jax.grad(loss_j)(jnp.asarray(feats)))

  ft = torch.from_numpy(feats).requires_grad_()
  out = tidx.index_features(ft, torch.from_numpy(idx))
  (out * torch.from_numpy(weight)).sum().backward()
  np.testing.assert_array_equal(out.detach().numpy(), want_out)
  tol = 1e-12 if dtype == np.float64 else 1e-5
  np.testing.assert_allclose(ft.grad.numpy(), want_grad, rtol=tol, atol=tol)
  counts = np.bincount(idx, minlength=50)
  unit = torch.from_numpy(feats).requires_grad_()
  tidx.index_features(unit, torch.from_numpy(idx)).sum().backward()
  np.testing.assert_array_equal(unit.grad.numpy()[:, 0], counts)


def sort_case(kind, n=600, seed=0):
  rng = np.random.default_rng(seed)
  segs = rng.integers(0, 7, n).astype(np.int32)
  if kind == "int_ties":
    keys = rng.integers(-5, 5, n).astype(np.int32)
  elif kind == "float_distinct":
    keys = rng.permutation(n).astype(np.float32) * 0.37 - 50.0
  elif kind == "float_ties":
    keys = rng.integers(0, 4, n).astype(np.float32) * 0.5
  elif kind == "signed_zeros_nan":
    keys = rng.choice(np.float32([0.0, -0.0, np.nan, 1.0, -1.0]), n)
  else:
    raise ValueError(kind)
  values = np.arange(n, dtype=np.int32)
  return keys, values, segs


@pytest.mark.parametrize("kind", ["int_ties", "float_distinct", "float_ties",
                                  "signed_zeros_nan"])
def test_segmented_sort_pairs_equal(kind):
  """Equal to ``lax.sort((segments, keys, values), num_keys=2)``.  Ties
  keep their input order on both sides (``lax.sort`` is stable); both
  keep -0.0 and 0.0 as equal keys in input order and order NaN last, so
  the signed-zero case agrees exactly too (checked on the values, which
  name each element)."""
  keys, values, segs = sort_case(kind)
  kj, vj = jidx.segmented_sort_pairs(jnp.asarray(keys), jnp.asarray(values),
                                     jnp.asarray(segs))
  kt, vt = tidx.segmented_sort_pairs(torch.from_numpy(keys),
                                     torch.from_numpy(values),
                                     torch.from_numpy(segs))
  np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
  np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
  np.testing.assert_array_equal(np.signbit(kt.numpy()),
                                np.signbit(np.asarray(kj)))


def test_segmented_sort_pairs_small():
  """``tests/test_io_morton.py``'s hand example."""
  keys = torch.tensor([3, 1, 2, 9, 0], dtype=torch.int32)
  vals = torch.tensor([30, 10, 20, 90, 0], dtype=torch.int32)
  segs = torch.tensor([1, 0, 1, 0, 0], dtype=torch.int32)
  sk, sv = tidx.segmented_sort_pairs(keys, vals, segs)
  assert sk.tolist() == [0, 1, 9, 2, 3]
  assert sv.tolist() == [0, 10, 90, 20, 30]
