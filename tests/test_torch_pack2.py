"""Port vs reference: the packed-table probes of ``benchmarks/exp_pack2.py``.

Each probe builds its own inputs, so its ``pallas_call`` is recorded
(``pl.pallas_call`` patched for the module) while the probe runs in TPU
interpret mode.  ``t2_timing`` calls its three under ``jax.jit``: of those
only the callable is recorded, and called again here on seeded slabs.
The port's CPU path (the twins of
``tpu_splatting_torch.benchmarks.exp_pack2``) must equal the recorded
output of ``v_a``, ``v_b`` and ``t2_timing``'s ``k_today`` and ``k_va``
exactly, and ``v_p``'s within the reference's own bar (1e-4 relative;
the port's permutation is exact).

``v_c`` and ``k_vc`` build the fetch-order unpack from ``pltpu.repeat``,
which has tile semantics in interpret mode (ROADMAP F12): what they
record is not the unpack they mean.  The port's counterparts
(``unpack_direct``, ``exp_pack.slab_relayout(packed=True)``) are held to
``rows.T`` and numpy instead, and the tests assert that the recorded
outputs differ from it, so that the F12 note stays true.  The kernels
themselves are held against these twins in test_torch_gpu.py and
chip_smoke.py.
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
from benchmarks import exp_pack2 as ref  # noqa: E402
from tpu_splatting_torch.benchmarks import exp_pack as ep  # noqa: E402
from tpu_splatting_torch.benchmarks import exp_pack2 as ep2  # noqa: E402

T2_STEPS = 4
SEEDS = [1, 2, 3]


reference_mode = pc.tpu_reference_mode


@pytest.fixture(scope="module")
def recorded():
  """{probe: [(its pallas_call, the arguments it was given or None, its
  output or None), ...]}, recorded while the reference's probe ran; under
  jit only the callable.  T2's are (k_today, k_va, k_vc)."""
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
    for key, probe in (("V_a", ref.v_a), ("V_b", ref.v_b),
                       ("V_c element", lambda: ref.v_c("element")),
                       ("V_c tile", lambda: ref.v_c("tile")),
                       ("V_p", ref.v_p),
                       ("T2", lambda: ref.t2_timing(steps=T2_STEPS))):
      probe()
      out[key] = list(calls)
      calls.clear()
  for key, n in (("V_a", 1), ("V_b", 1), ("V_c element", 1), ("V_c tile", 1),
                 ("V_p", 1), ("T2", 3)):
    assert len(out[key]) == n, (key, len(out[key]))
  return out


def cpu(a):
  return torch.from_numpy(np.array(a))


def table(shape, seed):
  return np.random.default_rng(seed).standard_normal(shape).astype(
      np.float32)


def test_reference_probes_as_recorded(recorded, capsys):
  """The reference's own checks: V_a OK, V_b tile, both V_c branches
  WRONG (F12), V_p within its bar."""
  with reference_mode():
    assert ref.v_a()
    assert ref.v_b() == "tile"
    assert not ref.v_c("element") and not ref.v_c("tile")
    assert ref.v_p()
  out = capsys.readouterr().out
  assert out.count(": OK") == 1 and out.count(": WRONG") == 2
  assert "TILE semantics" in out


def test_v_a_equals_probe(recorded):
  """On the probe's own packed block: the recorded output exactly, which
  is rows.T in perm_cprime's slot order."""
  ep2.reset_launch_counts()
  _, (xp,), want = recorded["V_a"][0]
  got = ep2.permuted_unpack(cpu(xp)[None], 16)[0].numpy()
  assert got.dtype == want.dtype and got.shape == want.shape == (16, 512)
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(got, ep2.probe_rows().T[:, ep2.perm_cprime()])
  np.testing.assert_array_equal(ep2.perm_cprime(), ref.perm_cprime())
  assert sum(ep2.probe_launch_counts.values()) == 0   # the twin ran


@pytest.mark.parametrize("seed", SEEDS)
def test_v_a_seeded(recorded, seed):
  """The recorded call on further seeded blocks; one batched call of the
  port holds every block."""
  fn = recorded["V_a"][0][0]
  x = table((seed, 64, 128), 10 * seed)
  got = ep2.permuted_unpack(cpu(x), 16).numpy()
  with reference_mode():
    for b in range(seed):
      np.testing.assert_array_equal(got[b], np.asarray(fn(jnp.asarray(x[b]))))


@pytest.mark.parametrize("w, p", [(11, 5), (12, 64), (16, 3)])
def test_permuted_unpack_definition(w, p):
  """Slot P k + p of float j is xp[b, p, k w + j], at widths and counts
  of packed rows the probe does not take."""
  x = table((2, p, 8 * w), w + p)
  got = ep2.permuted_unpack(cpu(x), w).numpy()
  for k in range(8):
    for j in range(w):
      np.testing.assert_array_equal(got[:, j, p * k:p * (k + 1)],
                                    x[:, :, k * w + j])


@pytest.mark.parametrize("seed", SEEDS)
def test_t2_k_va_last_slab(recorded, seed):
  """t2_timing's k_va on seeded slabs that all differ: the recorded call
  (its grid of 4 steps, each overwriting the one output) gives the last
  slab's block, which the twin equals exactly; the first slab's block is
  not it."""
  fn = recorded["T2"][1][0]
  x = table((T2_STEPS * 64, 128), 20 + seed)
  with reference_mode():
    want = np.asarray(fn(jnp.asarray(x)))
  got = ep2.slab_relayout_permuted(cpu(x)).numpy()
  np.testing.assert_array_equal(got, want)
  perm = ep2.perm_cprime()
  last, first = x[-64:].reshape(512, 16), x[:64].reshape(512, 16)
  np.testing.assert_array_equal(got, last.T[:, perm][:12, :128])
  assert not np.array_equal(got, first.T[:, perm][:12, :128])


@pytest.mark.parametrize("seed", SEEDS)
def test_t2_k_today_is_slab_relayout(recorded, seed):
  """t2_timing's k_today is exp_pack's flat slab relayout at C 12, which
  T2 runs as its first kernel."""
  fn = recorded["T2"][0][0]
  x = table((T2_STEPS * 512, 12), 30 + seed)
  with reference_mode():
    want = np.asarray(fn(jnp.asarray(x)))
  np.testing.assert_array_equal(ep.slab_relayout(cpu(x)).numpy(), want)


def test_v_b_tile(recorded):
  """The default mode is the probe's (tile) semantics: the recorded
  output exactly; element mode is np.repeat."""
  _, (x,), want = recorded["V_b"][0]
  x = np.asarray(x)
  got = ep2.repeat_rows(cpu(x)[None], 2)[0].numpy()
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(got, np.tile(x, (2, 1)))
  np.testing.assert_array_equal(
      ep2.repeat_rows(cpu(x)[None], 2, mode="element")[0].numpy(),
      np.repeat(x, 2, axis=0))


@pytest.mark.parametrize("mode", ["tile", "element"])
def test_repeat_rows_batched(mode):
  x = table((3, 5, 8), 4)
  got = ep2.repeat_rows(cpu(x), 3, mode).numpy()
  for b in range(3):
    want = (np.tile(x[b], (3, 1)) if mode == "tile" else
            np.repeat(x[b], 3, axis=0))
    np.testing.assert_array_equal(got[b], want)


def test_v_c_fetch_order(recorded):
  """unpack_direct computes what V_c means: rows.T, bit for bit
  exp_pack.unpack_rows in row order.  The recorded outputs of both V_c
  branches are not it (F12: tile-semantics repeat; the tile branch never
  writes its output)."""
  rows = ep2.probe_rows()
  xp = cpu(rows.reshape(64, 128))[None]
  got = ep2.unpack_direct(xp, 16)[0].numpy()
  np.testing.assert_array_equal(got, rows.T)
  np.testing.assert_array_equal(got, ep.unpack_rows(xp, 16, "row")[0].numpy())
  for key in ("V_c element", "V_c tile"):
    _, (xin,), out = recorded[key][0]
    np.testing.assert_array_equal(np.asarray(xin), rows.reshape(64, 128))
    assert out.shape == rows.T.shape and not np.array_equal(out, rows.T), key


@pytest.mark.parametrize("w", [11, 16])
def test_unpack_direct_batched(w):
  x = table((3, 7, 8 * w), w)
  got = ep2.unpack_direct(cpu(x), w).numpy()
  for b in range(3):
    np.testing.assert_array_equal(got[b], x[b].reshape(56, w).T)


@pytest.mark.parametrize("seed", SEEDS)
def test_t2_k_vc_is_not_fetch_order(recorded, seed):
  """k_vc means the fetch-order block of the last slab; in interpret
  mode it records another (F12).  The port's V_c in T2,
  exp_pack.slab_relayout(packed=True), gives the intended block."""
  fn = recorded["T2"][2][0]
  x = table((T2_STEPS * 64, 128), 40 + seed)
  with reference_mode():
    recorded_block = np.asarray(fn(jnp.asarray(x)))
  want = x[-64:].reshape(512, 16).T[:12, :128]
  got = ep.slab_relayout(cpu(x), packed=True).numpy()
  np.testing.assert_array_equal(got, want)
  assert recorded_block.shape == want.shape
  assert not np.array_equal(recorded_block, want)


def test_v_p_exact_and_within_the_probe(recorded):
  """permute_lanes is x[:, inv] exactly, and within the reference's 1e-4
  relative of the recorded split-bf16 matmul."""
  _, (x, _), out = recorded["V_p"][0]
  x = np.asarray(x)
  np.testing.assert_array_equal(x, ep2.probe_gradient())
  perm = torch.as_tensor(ep2.perm_cprime(), dtype=torch.int32)
  got = ep2.permute_lanes(cpu(x)[None], perm)[0].numpy()
  inv = np.empty(512, np.int64)
  inv[ep2.perm_cprime()] = np.arange(512)
  np.testing.assert_array_equal(got, x[:, inv])
  rel = np.abs(out - got) / np.maximum(np.abs(got), 1e-30)
  assert rel.max() < 1e-4
  assert not np.array_equal(out, got)   # the matmul is not exact


def test_permute_lanes_definition():
  """out[b, r, perm[c']] = x[b, r, c'] for a random permutation."""
  x = table((2, 3, 64), 5)
  perm = np.random.default_rng(6).permutation(64)
  got = ep2.permute_lanes(cpu(x), torch.as_tensor(perm)).numpy()
  want = np.empty_like(x)
  want[..., perm] = x
  np.testing.assert_array_equal(got, want)


def test_shape_checks():
  """Shape errors raise before the device is chosen."""
  with pytest.raises(ValueError, match=r"\(B, P, 8 w\)"):
    ep2.permuted_unpack(torch.zeros((1, 4, 90)), 11)
  with pytest.raises(ValueError, match=r"\(B, P, 8 w\)"):
    ep2.unpack_direct(torch.zeros((4, 128)), 16)
  with pytest.raises(ValueError, match=r"\(S 64, 128\)"):
    ep2.slab_relayout_permuted(torch.zeros((64, 96)))
  with pytest.raises(ValueError, match=r"\(S 64, 128\)"):
    ep2.slab_relayout_permuted(torch.zeros((100, 128)))
  with pytest.raises(ValueError, match="mode one of"):
    ep2.repeat_rows(torch.zeros((1, 8, 128)), 2, "diagonal")
  with pytest.raises(ValueError, match="n > 0"):
    ep2.repeat_rows(torch.zeros((1, 8, 128)), 0)
  with pytest.raises(ValueError, match=r"perm \(L,\)"):
    ep2.permute_lanes(torch.zeros((1, 2, 8)), torch.arange(7))
  with pytest.raises(ValueError, match="not a permutation"):
    ep2.permute_lanes(torch.zeros((1, 2, 4)), torch.tensor([0, 1, 1, 3]))


def test_main_on_cpu_prints_the_reference_lines(capsys):
  ep2.main(["--device", "cpu", "--steps", str(T2_STEPS)])
  lines = capsys.readouterr().out.splitlines()
  assert lines[:4] == ["V_a transpose+slice+concat (permuted): OK",
                       "V_b repeat_rows: TILE semantics (np.tile)",
                       "V_c direct read (fetch order): OK",
                       "V_p lane permute: rel_max=0.00e+00 rel_p99=0.00e+00"]
  for line, name in zip(lines[4:], ("today (512,12)T", "V_a", "V_c")):
    assert line.startswith(f"T2 {name}: ") and "us/slab" in line
  assert "WRONG" not in "".join(lines) and len(lines) == 7


def test_port_module_imports_no_jax():
  """The port's module, imported alone, brings in no JAX, nothing of the
  JAX package and nothing of its benchmarks."""
  code = ("import sys, tpu_splatting_torch.benchmarks.exp_pack2; "
          "print(sorted(m for m in sys.modules if m.split('.')[0] in "
          "('jax', 'jaxlib', 'tpu_splatting', 'benchmarks')))")
  out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, check=True)
  assert out.stdout.strip() == "[]"
