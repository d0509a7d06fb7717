"""Port vs reference: the packed-table probes of ``benchmarks/exp_pack.py``.

Each probe builds its own inputs, so its ``pallas_call`` is recorded
(``pl.pallas_call`` patched for the module) while the probe runs in TPU
interpret mode.  ``t1_timing`` and ``f1_fetch`` call theirs under
``jax.jit``: of those only the callable is recorded, and called again
here on seeded inputs.  The port's CPU path (the twins of
``tpu_splatting_torch.benchmarks.exp_pack``) must equal the recorded
output exactly.

``f1_fetch``'s kernel adds every grid step into an output that no step
zeroes, so what it records is not the column sums (ROADMAP F13: NaN
here).  Its twin is held to numpy's f64 column sums of the rows the grid
covers instead, within 1e-6 of each column's sum of |x|, and to the
recorded call's shape only.  The kernels themselves are held against
these twins in test_torch_gpu.py and chip_smoke.py.
"""

import subprocess
import sys

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

import port_compare as pc  # noqa: E402
from benchmarks import exp_pack as ref  # noqa: E402
from tpu_splatting_torch.benchmarks import exp_pack as ep  # noqa: E402

UNPACK = {"U1": (ref.u1_unpack_rowmajor, 16, "row"),
          "U1b": (ref.u1b_unpack_rowmajor_w11, 11, "row"),
          "U2": (ref.u2_unpack_colmajor, 12, "col")}
T1_STEPS, F1_N, S_CAP = 4, 8192, 1024


reference_mode = pc.tpu_reference_mode


@pytest.fixture(scope="module")
def recorded():
  """{probe: [(its pallas_call, the arguments it was given or None, its
  output or None), ...]}, recorded while the reference's probe ran; under
  jit only the callable."""
  calls = []
  real = pl.pallas_call

  def recorder(*args, **kwargs):
    fn = real(*args, **kwargs)

    def call(*inputs):
      out = fn(*inputs)
      if isinstance(out, jax.core.Tracer):
        calls.append((fn, None, None))
      else:
        calls.append((fn, inputs, np.asarray(out)))
      return out
    return call

  out = {}
  with pytest.MonkeyPatch.context() as mp, reference_mode():
    mp.setattr(pl, "pallas_call", recorder)
    for key, (probe, _, _) in UNPACK.items():
      assert probe()
      out[key] = list(calls)
      calls.clear()
    ref.t1_timing(steps=T1_STEPS)
    out["T1"] = list(calls)
    calls.clear()
    ref.f1_fetch(n=F1_N, s_cap=S_CAP)
    out["F1"] = list(calls)
  for key, n in (("U1", 1), ("U1b", 1), ("U2", 1), ("T1", 2), ("F1", 2)):
    assert len(out[key]) == n, (key, len(out[key]))
  return out


def test_reference_mode_isolates_a_failed_kernel():
  """F21: an interpreted kernel that fails after its dispatch returned
  (exp_mosaic's T4 reading past its table, on an input that is not
  ready yet, so that XLA runs it asynchronously) leaves a failed token of
  ordered effects and the interpret mode's memory behind; the next
  ``reference_mode`` block starts without them and its probe passes."""
  from jax.experimental.pallas import tpu as pltpu

  from benchmarks import exp_mosaic
  calls = []
  real = pl.pallas_call

  def recorder(*args, **kwargs):
    calls.append(real(*args, **kwargs))
    return calls[-1]

  with pytest.MonkeyPatch.context() as mp, reference_mode():
    mp.setattr(pl, "pallas_call", recorder)
    exp_mosaic.t4_dma_packed_rows()
  x = jnp.asarray(table((256, 128), 6))
  big = jnp.ones((2048, 2048), jnp.float32)
  with pltpu.force_tpu_interpret_mode(), jax.enable_x64(False):
    pending = jax.jit(lambda b, a: a + 0.0 * jnp.sum(b @ b))(big, x)
    with pytest.raises(Exception, match="Out-of-bounds"):
      jax.block_until_ready(calls[0](jnp.asarray([193], jnp.int32), pending))
  with reference_mode():
    assert ref.u1_unpack_rowmajor()


def test_probes_print_ok(recorded, capsys):
  """The reference's own check passed on every unpack probe."""
  with reference_mode():
    for probe, _, _ in UNPACK.values():
      probe()
  assert capsys.readouterr().out.count(": OK") == 3


def cpu(a):
  return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("key", sorted(UNPACK))
def test_unpack_equals_probe(recorded, key):
  """On the probe's own packed table: the recorded output exactly."""
  ep.reset_launch_counts()
  _, w, order = UNPACK[key]
  _, (xp,), want = recorded[key][0]
  got = ep.unpack_rows(cpu(xp)[None], w, order)[0].numpy()
  assert got.dtype == want.dtype and got.shape == want.shape
  np.testing.assert_array_equal(got, want)
  assert sum(ep.probe_launch_counts.values()) == 0   # the twin ran


def table(shape, seed):
  return np.random.default_rng(seed).standard_normal(shape).astype(
      np.float32)


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("key", sorted(UNPACK))
def test_unpack_seeded(recorded, key, seed):
  """The recorded call on further seeded tables; one batched call of the
  port holds every table."""
  _, w, order = UNPACK[key]
  fn, (xp0,), _ = recorded[key][0]
  x = table((seed,) + xp0.shape, 10 * seed)
  got = ep.unpack_rows(cpu(x), w, order).numpy()
  with reference_mode():
    for b in range(seed):
      want = np.asarray(fn(jnp.asarray(x[b])))
      np.testing.assert_array_equal(got[b], want)


def test_unpack_orders_twin_numpy():
  """Both orders against the definition, at a width and count of packed
  rows the probes do not take."""
  x = table((3, 5, 8 * 7), 4)
  row = ep.unpack_rows(cpu(x), 7, "row").numpy()
  col = ep.unpack_rows(cpu(x), 7, "col").numpy()
  for b in range(3):
    for p in range(5):
      for k in range(8):
        for j in range(7):
          assert row[b, j, 8 * p + k] == x[b, p, k * 7 + j]
          assert col[b, j, 8 * p + k] == x[b, p, j * 8 + k]


@pytest.mark.parametrize("packed", [False, True])
def test_t1_last_slab(recorded, packed):
  """t1_timing's kernels on seeded slabs that all differ: the recorded
  call (its grid of 4 steps, each overwriting the one output) gives the
  last slab's block, which the twin equals exactly; the first slab's
  block is not it."""
  fn = recorded["T1"][int(packed)][0]
  shape = ((T1_STEPS * 64, 128) if packed else (T1_STEPS * 512, 12))
  x = table(shape, 5 + int(packed))
  with reference_mode():
    want = np.asarray(fn(jnp.asarray(x)))
  got = ep.slab_relayout(cpu(x), packed).numpy()
  np.testing.assert_array_equal(got, want)
  rows = 64 if packed else 512
  last, first = x[-rows:], x[:rows]
  if packed:
    last, first = last.reshape(512, 16), first.reshape(512, 16)
  np.testing.assert_array_equal(got, last.T[:12, :128])
  assert not np.array_equal(got, first.T[:12, :128])


def test_t1_port_stride():
  """At the stream table's stride (C 32): the first 12 floats of the last
  slab's first 128 rows, transposed."""
  x = table((3 * 512, 32), 7)
  np.testing.assert_array_equal(ep.slab_relayout(cpu(x)).numpy(),
                                x[-512:-384, :12].T)


@pytest.mark.parametrize("n", [F1_N, F1_N + 100])
@pytest.mark.parametrize("packed", [False, True])
def test_f1_column_sums(recorded, n, packed):
  """The twin starts from zero: numpy's f64 column sums of the rows the
  grid covers (not the tail), within 1e-6 of each column's sum of |x|;
  the recorded call (F13: it adds into an unzeroed output) has the same
  shape."""
  fn = recorded["F1"][int(packed)][0]
  rows, shape = ((S_CAP // 8, (n // 8, 128)) if packed else
                 (S_CAP, (n, 12)))
  x = table(shape, 8 + n)
  g = shape[0] // rows
  got = ep.column_sums(cpu(x), rows).numpy()
  covered = x[:g * rows].astype(np.float64)
  want = covered.sum(0, keepdims=True)
  assert got.shape == want.shape and got.dtype == np.float32
  assert np.all(np.abs(got - want) <= 1e-6 * np.abs(covered).sum(0))
  if n % S_CAP:   # the tail's rows changed nothing
    assert not np.allclose(want, x.astype(np.float64).sum(0, keepdims=True))
  with reference_mode():
    assert np.asarray(fn(jnp.asarray(x[:F1_N // (8 if packed else 1)]))
                      ).shape == got.shape


def test_shape_checks():
  """Shape errors raise before the device is chosen."""
  with pytest.raises(ValueError, match=r"\(B, P, 8 w\)"):
    ep.unpack_rows(torch.zeros((1, 4, 90)), 11)
  with pytest.raises(ValueError, match="order one of"):
    ep.unpack_rows(torch.zeros((1, 4, 88)), 11, "diagonal")
  with pytest.raises(ValueError, match=r"C >= 12"):
    ep.slab_relayout(torch.zeros((512, 8)))
  with pytest.raises(ValueError, match=r"\(S 512"):
    ep.slab_relayout(torch.zeros((500, 12)))
  with pytest.raises(ValueError, match=r"\(S 64, 128\)"):
    ep.slab_relayout(torch.zeros((64, 96)), packed=True)
  with pytest.raises(ValueError, match="block_rows > 0"):
    ep.column_sums(torch.zeros((8, 12)), 0)


def test_column_sums_short_table_is_zero():
  """Fewer rows than one block: no block, the sums are 0."""
  np.testing.assert_array_equal(
      ep.column_sums(torch.ones((100, 12)), 1024).numpy(), np.zeros((1, 12)))


def test_main_on_cpu_prints_the_reference_lines(capsys):
  ep.main(["--device", "cpu", "--steps", "4", "--n", "8192"])
  lines = capsys.readouterr().out.splitlines()
  assert lines[:3] == ["U1 w_pad16 reshape+transpose: OK",
                       "U1b rowmajor w=11: OK", "U2 colmajor 3d-transpose: OK"]
  assert lines[3].startswith("T1 4 slabs: transpose-only ")
  assert lines[5].startswith("F1 one table pass (8 blocks): flat ")
  assert "WRONG" not in "".join(lines) and len(lines) == 6


def test_port_module_imports_no_jax():
  """The port's module, imported alone, brings in no JAX, nothing of the
  JAX package and nothing of its benchmarks."""
  code = ("import sys, tpu_splatting_torch.benchmarks.exp_pack; "
          "print(sorted(m for m in sys.modules if m.split('.')[0] in "
          "('jax', 'jaxlib', 'tpu_splatting', 'benchmarks')))")
  out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, check=True)
  assert out.stdout.strip() == "[]"
