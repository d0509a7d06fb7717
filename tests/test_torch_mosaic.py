"""Port vs reference: the data-movement probes of ``benchmarks/exp_mosaic.py``.

Each probe builds its own inputs and returns nothing, so its
``pallas_call`` is recorded (``pl.pallas_call`` patched for the module)
while the probe runs in TPU interpret mode.  The port's CPU path (the
twins of ``tpu_splatting_torch.benchmarks.exp_mosaic``) must equal the
recorded output exactly on the probe's inputs, and the recorded reference
called again on further offsets.  The probes run with x64 off: T1's and
T3's ``dynamic_slice`` refuse an int32 start beside the int64 0 that x64
makes (ROADMAP F11).  The kernels themselves are held against these twins
in test_torch_gpu.py and chip_smoke.py.
"""


import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

import port_compare as pc  # noqa: E402
from benchmarks import exp_mosaic as ref  # noqa: E402
from tpu_splatting_torch.benchmarks import exp_mosaic as em  # noqa: E402

PROBES = {"T1": ref.t1_dynamic_sublane_slice, "T2": ref.t2_reshape,
          "T3": ref.t3_double_blockspec_window, "T4": ref.t4_dma_packed_rows}


reference_mode = pc.tpu_reference_mode


@pytest.fixture(scope="module")
def recorded():
  """{probe: (its pallas_call, the arguments it was given, its output)},
  recorded while the reference's probe ran."""
  calls = []
  real = pl.pallas_call

  def recorder(*args, **kwargs):
    fn = real(*args, **kwargs)

    def call(*inputs):
      out = fn(*inputs)
      calls.append((fn, inputs, np.asarray(out)))
      return out
    return call

  out = {}
  with pytest.MonkeyPatch.context() as mp, reference_mode():
    mp.setattr(pl, "pallas_call", recorder)
    for key, probe in PROBES.items():
      probe()
      assert len(calls) == 1, (key, len(calls))
      out[key] = calls.pop()
  return out


def test_probes_print_ok(recorded, capsys):
  """The reference's own check passed on every probe it recorded."""
  with reference_mode():
    for probe in PROBES.values():
      probe()
  assert capsys.readouterr().out.count(": OK") == 4


def cpu(a):
  return torch.from_numpy(np.array(a))


def port_on(key, inputs):
  """The port's CPU path on a probe's arguments (numpy)."""
  if key == "T1":
    d, x = inputs
    return em.dynamic_slice_rows(cpu(x)[None], cpu(d), 128)[0]
  if key == "T2":
    (x,) = inputs
    return em.reshape_rows(cpu(x), 16)
  if key == "T3":
    src, x, _ = inputs
    return em.double_block_window(cpu(x), cpu(src), 128).reshape(-1, 16)
  s, x = inputs
  return em.dma_residue_sum(cpu(x), cpu(s), 64)[0]


@pytest.mark.parametrize("key", sorted(PROBES))
def test_port_equals_probe(recorded, key):
  em.reset_launch_counts()
  _, inputs, want = recorded[key]
  got = port_on(key, inputs).numpy()
  assert got.dtype == want.dtype and got.shape == want.shape
  np.testing.assert_array_equal(got, want)
  assert sum(em.probe_launch_counts.values()) == 0   # the twin ran


def table(shape, seed):
  return np.random.default_rng(seed).standard_normal(shape).astype(
      np.float32)


T1_OFFSETS = (0, 37, 128, 129, 200, 300, -1, -5, -200, -256, -257)


@pytest.mark.parametrize("d", T1_OFFSETS)
def test_t1_offsets(recorded, d):
  """The negative starts wrap by R before they clamp (-5 starts at 128,
  -200 at 56), on a seeded table."""
  fn, _, _ = recorded["T1"]
  x = table((256, 16), 1)
  with reference_mode():
    want = np.asarray(fn(jnp.asarray([d], jnp.int32), jnp.asarray(x)))
  got = port_on("T1", (np.asarray([d], np.int32), x)).numpy()
  np.testing.assert_array_equal(got, want)


def test_t1_batch_is_each_offset(recorded):
  """One batched call equals the reference at each offset."""
  fn, _, _ = recorded["T1"]
  x = table((len(T1_OFFSETS), 256, 16), 2)
  got = em.dynamic_slice_rows(cpu(x), torch.tensor(T1_OFFSETS,
                                                   dtype=torch.int32), 128)
  with reference_mode():
    for i, d in enumerate(T1_OFFSETS):
      want = np.asarray(fn(jnp.asarray([d], jnp.int32), jnp.asarray(x[i])))
      np.testing.assert_array_equal(got[i].numpy(), want)


@pytest.mark.parametrize("src", [(0, 895, 767), (127, 128, 129),
                                 (1, 383, 640)])
def test_t3_windows(recorded, src):
  fn, _, _ = recorded["T3"]
  x = table((1024, 16), 3)
  src = np.asarray(src, np.int32)
  with reference_mode():
    want = np.asarray(fn(jnp.asarray(src), jnp.asarray(x), jnp.asarray(x)))
  got = port_on("T3", (src, x, x)).numpy()
  np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("s", [0, 19, 192])
def test_t4_offsets(recorded, s):
  """The residues are added in p order from 0: equal bit for bit."""
  fn, _, _ = recorded["T4"]
  x = table((256, 128), 4)
  with reference_mode():
    want = np.asarray(fn(jnp.asarray([s], jnp.int32), jnp.asarray(x)))
  got = port_on("T4", (np.asarray([s], np.int32), x)).numpy()
  np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("key, offset", [("T3", 896), ("T3", -3),
                                         ("T4", 193), ("T4", -1)])
def test_twins_raise_where_the_reference_raises(recorded, key, offset):
  """A window past the table: the reference's interpret mode fails its
  out-of-bounds read, the twins raise ValueError."""
  fn, _, _ = recorded[key]
  if key == "T3":
    x = table((1024, 16), 5)
    src = np.asarray([offset, 0, 5], np.int32)
    ref_args = (jnp.asarray(src), jnp.asarray(x), jnp.asarray(x))
    port_args = (src, x, x)
  else:
    x = table((256, 128), 6)
    src = np.asarray([offset], np.int32)
    ref_args = (jnp.asarray(src), jnp.asarray(x))
    port_args = (src, x)
  with reference_mode(), pytest.raises(Exception):
    jax.block_until_ready(fn(*ref_args))
  with pytest.raises(ValueError, match="outside"):
    port_on(key, port_args)


@pytest.mark.parametrize("w", [4, 8, 16, 32])
def test_reshape_rows_twin_any_width(w):
  x = table((64, 128), 7)
  np.testing.assert_array_equal(em.reshape_rows(cpu(x), w).numpy(),
                                x.reshape(-1, w))


def test_shape_checks():
  """Shape errors raise before the device is chosen."""
  x = torch.zeros((1000, 16))
  with pytest.raises(ValueError, match="multiple of g"):
    em.double_block_window(x, torch.zeros(1, dtype=torch.int32), 128)
  with pytest.raises(ValueError, match="w divides C"):
    em.reshape_rows(torch.zeros((4, 12)), 8)
  with pytest.raises(ValueError, match="0 < n <= R"):
    em.dynamic_slice_rows(torch.zeros((1, 8, 4)), torch.zeros(
        1, dtype=torch.int32), 9)
  with pytest.raises(ValueError, match=r"\(R, 128\)"):
    em.dma_residue_sum(torch.zeros((8, 64)), torch.zeros(1, dtype=torch.int32))


def test_main_on_cpu_prints_four_ok(capsys):
  em.main(["--device", "cpu"])
  lines = capsys.readouterr().out.splitlines()
  assert lines == ["T1 dynamic sublane slice: OK", "T2 contiguous reshape: OK",
                   "T3 double-blockspec window: OK",
                   "T4 packed-row DMA + residue slices: OK"]
