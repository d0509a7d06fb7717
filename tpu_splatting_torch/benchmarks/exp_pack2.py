"""Packed-table probes, round 2: the counterpart of ``benchmarks/exp_pack2.py``.

The reference's probes ask how a packed slab (8 logical rows of w floats a
packed row) becomes per-float lane vectors on a TPU, whose compiler
rejects the reshape that exp_pack's path needs: in a permuted slot order
(V_a), by a repeat of the packed rows (V_b, V_c), and what the permuted
order's backward permutation costs (V_p).  Here each is a function over a
batch of blocks, a hand-written kernel in ``csrc/exp_pack2.cu`` with a
plain-torch twin, so the reference's probe (a batch of one) and a
measurement at scale run the same code.  They lie on no product path
(``PERF.md``).

* ``permuted_unpack`` (V_a): ``xp`` (B, P, 8 w) to (B, w, 8 P) with
  ``out[b, j, P k + p] = xp[b, p, k w + j]``: slot c' = P k + p holds
  logical row 8 p + k (at P 64 the reference's ``perm_cprime``).
* ``slab_relayout_permuted`` (``t2_timing``'s ``k_va``): the (12, 128)
  block of the LAST slab of (S 64, 128), ``[:12, :128]`` of its permuted
  unpack, as the reference's grid leaves it; every slab is still read and
  re-laid.
* ``repeat_rows`` (V_b): (B, R, C) to (B, n R, C), ``out[b, i] = x[b, i %
  R]`` (``mode="tile"``, what the reference's ``pltpu.repeat`` computes
  on the CPU) or ``x[b, i // n]`` (``mode="element"``).
* ``unpack_direct`` (V_c and ``k_vc``): the fetch-order unpack that V_c
  means to compute (ROADMAP F12: its recorded outputs are not it),
  ``out[b, j, s]`` = float j of logical row s, bit for bit
  ``exp_pack.unpack_rows(xp, w, "row")``; the kernel reads each row
  straight from device memory, with no staging.
* ``permute_lanes`` (V_p): ``out[b, r, perm[c']] = x[b, r, c']``, exact
  (the reference's one-hot matmul in split bf16 is within 1e-4).

A CPU tensor goes to the ``*_reference`` twin, a CUDA tensor to the kernel
(built at first use; each call counted in ``probe_launch_counts``), or the
call raises.

    python -m tpu_splatting_torch.benchmarks.exp_pack2 [--device cpu]
        [--steps S]

prints the reference's lines for the probes' own inputs (V_a, V_c ``OK``,
V_b's semantics, V_p's relative error, T2's three times: by CUDA events
on the card, by the host clock of the twins with ``--device cpu``), on
the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import ctypes
import functools

import numpy as np
import torch

from ..utils.cuda_build import (KernelPlan, check_smem, launch_stream,
                                load_kernel_library)
from . import exp_pack
from .exp_mosaic import _check_float4

# calls per wrapper; none lies on a product path
probe_launch_counts = {"permuted_unpack": 0, "slab_relayout_permuted": 0,
                       "repeat_rows": 0, "unpack_direct": 0,
                       "permute_lanes": 0}

PACK = exp_pack.PACK              # logical rows a packed row
SLAB_P, SLAB_W = 64, 16           # slab_relayout_permuted: P and w a slab
OUT_ROWS, OUT_COLS = exp_pack.OUT_ROWS, exp_pack.OUT_COLS
LANE_ROWS = 8                     # permute_lanes: rows a block
MODES = ("tile", "element")
# tpu_splat_pack2_occupancy's kernel numbers
OCCUPANCY_KERNELS = {"permuted_unpack": 0, "slab_relayout_permuted": 1,
                     "repeat_rows tile": 2, "repeat_rows element": 3,
                     "unpack_direct": 4, "permute_lanes": 5}


def reset_launch_counts():
  for k in probe_launch_counts:
    probe_launch_counts[k] = 0


def perm_cprime(c_cap: int = 512, rpb: int = 8) -> np.ndarray:
  """The fetch slot c = 8 r8 + k of permuted lane c' = 64 k + r8 (the
  reference's ``perm_cprime``)."""
  cp = np.arange(c_cap)
  return rpb * (cp % (c_cap // rpb)) + cp // (c_cap // rpb)


def permuted_smem(p: int, w: int) -> int:
  """Shared bytes of a permuted_unpack block: 8 p slots at the odd stride
  w | 1, the slot groups shifted by up to 19 words."""
  return (PACK * p * (w | 1) + 19) * 4


def lane_smem(l: int) -> int:
  """Shared bytes of a permute_lanes block: 8 rows of l floats, 4 words
  of padding after every 32."""
  return LANE_ROWS * (l + 4 * -(-l // 32)) * 4


def permuted_unpack_reference(xp: torch.Tensor, w: int) -> torch.Tensor:
  """Plain-torch twin of ``permuted_unpack``: a permute and a copy."""
  b, p, _ = xp.shape
  return xp.reshape(b, p, PACK, w).permute(0, 3, 2, 1).reshape(b, w, PACK * p)


def slab_relayout_permuted_reference(x: torch.Tensor) -> torch.Tensor:
  """Plain-torch twin of ``slab_relayout_permuted``: the last slab only."""
  return permuted_unpack_reference(x[-SLAB_P:][None], SLAB_W)[
      0, :OUT_ROWS, :OUT_COLS].contiguous()


def repeat_rows_reference(x: torch.Tensor, n: int,
                          mode: str = "tile") -> torch.Tensor:
  """Plain-torch twin of ``repeat_rows``: ``repeat`` (tile) or
  ``repeat_interleave`` (element) along the rows."""
  if mode == "tile":
    return x.repeat(1, n, 1)
  return x.repeat_interleave(n, 1)


def unpack_direct_reference(xp: torch.Tensor, w: int) -> torch.Tensor:
  """Plain-torch twin of ``unpack_direct``: a reshape and a transpose."""
  return exp_pack.unpack_rows_reference(xp, w, "row")


def lane_inverse(perm: torch.Tensor) -> torch.Tensor:
  """inv (L,) int64 on the CPU with inv[perm[c']] = c'; ValueError unless
  perm is a permutation of 0..L-1."""
  p = perm.detach().to("cpu", torch.int64)
  n = p.shape[0]
  if perm.dim() != 1 or not torch.equal(torch.sort(p).values,
                                        torch.arange(n)):
    raise ValueError(f"permute_lanes: perm {tuple(perm.shape)} is not a "
                     "permutation of 0..L-1")
  inv = torch.empty(n, dtype=torch.int64)
  inv[p] = torch.arange(n)
  return inv


def permute_lanes_reference(x: torch.Tensor, perm: torch.Tensor
                            ) -> torch.Tensor:
  """Plain-torch twin of ``permute_lanes``: an index_select by the
  inverse."""
  return x.index_select(-1, lane_inverse(perm).to(x.device))


@functools.cache
def _kernel():
  lib = load_kernel_library("exp_pack2.cu")
  vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
  for name, args in (
      ("tpu_splat_permuted_unpack", [vp, vp] + [i] * 4 + [ll, vp]),
      ("tpu_splat_repeat_rows", [vp, vp] + [i] * 5 + [vp]),
      ("tpu_splat_unpack_direct", [vp, vp] + [i] * 3 + [vp]),
      ("tpu_splat_permute_lanes", [vp] * 3 + [i] * 2 + [ll, vp]),
      ("tpu_splat_pack2_occupancy", [i, ll, ctypes.POINTER(i)])):
    fn = getattr(lib, name)
    fn.restype = i
    fn.argtypes = args
  lib.tpu_splat_pack2_smem.restype = ll
  lib.tpu_splat_pack2_smem.argtypes = [i] * 3
  return lib


def occupancy(kernel: str, smem: int) -> dict:
  """Resident blocks and warps per SM, registers and local bytes of one
  probe kernel (``OCCUPANCY_KERNELS``) at 256 threads and ``smem`` bytes
  of dynamic shared memory."""
  out = (ctypes.c_int * 3)()
  err = _kernel().tpu_splat_pack2_occupancy(OCCUPANCY_KERNELS[kernel], smem,
                                            out)
  if err != 0:
    raise RuntimeError(f"pack2 occupancy: CUDA error {err}")
  return {"blocks_per_sm": out[0], "warps_per_sm": out[0] * 8,
          "registers": out[1], "local_bytes": out[2]}


def _launched(name, err):
  if err != 0:
    raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
  probe_launch_counts[name] += 1


def _check_32bit(name: str, *counts):
  """The kernels index in 32 bits: ValueError past 2^31 elements."""
  if max(counts) >= 2 ** 31:
    raise ValueError(f"{name} kernel: {max(counts)} elements exceed 32-bit "
                     "indices")


def _check_packed(name: str, xp: torch.Tensor, w: int):
  if xp.dim() != 3 or w <= 0 or xp.shape[2] != PACK * w:
    raise ValueError(f"{name}: xp {tuple(xp.shape)}, w {w}: xp is "
                     "(B, P, 8 w)")


def permuted_unpack(xp: torch.Tensor, w: int) -> torch.Tensor:
  """(B, w, 8 P) in the permuted slot order from (B, P, 8 w) f32 packed
  8 logical rows a row: ``out[b, j, P k + p] = xp[b, p, k w + j]``.  The
  kernel stages each block in shared memory (``permuted_smem`` bytes)."""
  _check_packed("permuted_unpack", xp, w)
  if xp.device.type == "cpu":
    return permuted_unpack_reference(xp, w)
  xp = exp_pack._cuda_input("permuted_unpack", xp, 3, float4=True)
  b, p, _ = xp.shape
  smem = permuted_smem(p, w)
  check_smem("permuted_unpack", KernelPlan(0, 256, smem), f"P {p}, w {w}")
  out = torch.empty((b, w, PACK * p), dtype=xp.dtype, device=xp.device)
  if out.numel() == 0:
    return out
  with launch_stream(xp.device) as stream:
    err = _kernel().tpu_splat_permuted_unpack(xp.data_ptr(), out.data_ptr(),
                                              b, p, w, 0, smem, stream)
  _launched("permuted_unpack", err)
  return out


def slab_relayout_permuted(x: torch.Tensor) -> torch.Tensor:
  """(12, 128): the last slab's block of x, (S 64, 128) f32, in the
  permuted slot order (``out[j, i]`` = float j of slot i).  The kernel
  reads and re-lays every slab in shared memory; the last slab's block
  writes the result."""
  if (x.dim() != 2 or x.shape[1] != PACK * SLAB_W or x.shape[0] == 0
      or x.shape[0] % SLAB_P):
    raise ValueError(f"slab_relayout_permuted: x {tuple(x.shape)}: x is "
                     f"(S {SLAB_P}, {PACK * SLAB_W}), S > 0")
  if x.device.type == "cpu":
    return slab_relayout_permuted_reference(x)
  x = exp_pack._cuda_input("slab_relayout_permuted", x, 2, float4=True)
  out = torch.empty((OUT_ROWS, OUT_COLS), dtype=x.dtype, device=x.device)
  smem = permuted_smem(SLAB_P, SLAB_W)
  with launch_stream(x.device) as stream:
    err = _kernel().tpu_splat_permuted_unpack(
        x.data_ptr(), out.data_ptr(), x.shape[0] // SLAB_P, SLAB_P, SLAB_W,
        1, smem, stream)
  _launched("slab_relayout_permuted", err)
  return out


def repeat_rows(x: torch.Tensor, n: int, mode: str = "tile") -> torch.Tensor:
  """(B, n R, C) from x (B, R, C) f32: ``out[b, i] = x[b, i % R]`` (tile)
  or ``x[b, i // n]`` (element).  The kernel copies one float4 a thread,
  so C is a multiple of 4."""
  if x.dim() != 3 or n <= 0 or mode not in MODES:
    raise ValueError(f"repeat_rows: x {tuple(x.shape)}, n {n}, mode "
                     f"{mode!r}: x is (B, R, C), n > 0, mode one of {MODES}")
  if x.device.type == "cpu":
    return repeat_rows_reference(x, n, mode)
  x = exp_pack._cuda_input("repeat_rows", x, 3, float4=True)
  b, r, c = x.shape
  _check_float4("repeat_rows", ("a row", c * 4))
  out = torch.empty((b, n * r, c), dtype=x.dtype, device=x.device)
  if out.numel() == 0:
    return out
  _check_32bit("repeat_rows", out.numel() // 4)
  with launch_stream(x.device) as stream:
    err = _kernel().tpu_splat_repeat_rows(x.data_ptr(), out.data_ptr(), b, r,
                                          c, n, int(mode == "element"),
                                          stream)
  _launched("repeat_rows", err)
  return out


def unpack_direct(xp: torch.Tensor, w: int) -> torch.Tensor:
  """(B, w, 8 P) in fetch order from (B, P, 8 w) f32 packed 8 logical
  rows a row: ``out[b, j, s]`` = float j of logical row s.  Each thread
  of the kernel reads one logical row straight from device memory."""
  _check_packed("unpack_direct", xp, w)
  if xp.device.type == "cpu":
    return unpack_direct_reference(xp, w)
  xp = exp_pack._cuda_input("unpack_direct", xp, 3, float4=w % 4 == 0)
  b, p, _ = xp.shape
  out = torch.empty((b, w, PACK * p), dtype=xp.dtype, device=xp.device)
  if out.numel() == 0:
    return out
  _check_32bit("unpack_direct", b * PACK * p)
  with launch_stream(xp.device) as stream:
    err = _kernel().tpu_splat_unpack_direct(xp.data_ptr(), out.data_ptr(), b,
                                            p, w, stream)
  _launched("unpack_direct", err)
  return out


@functools.lru_cache(maxsize=8)
def _device_inverse(perm_bytes: bytes, device: str) -> torch.Tensor:
  perm = torch.from_numpy(np.frombuffer(perm_bytes, dtype=np.int64).copy())
  return lane_inverse(perm).to(device, torch.int32)


def permute_lanes(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
  """(B, R, L) with ``out[b, r, perm[c']] = x[b, r, c']``, x (B, R, L) f32
  and perm (L,) a permutation of the lanes.  The inverse is computed on
  the host (a CUDA perm is read back once a call) and kept on the device
  for the next call with the same perm; the kernel stages rows in shared
  memory and writes ``out[..., c] = x[..., inv[c]]`` coalesced."""
  if x.dim() != 3 or perm.shape != (x.shape[2],):
    raise ValueError(f"permute_lanes: x {tuple(x.shape)}, perm "
                     f"{tuple(perm.shape)}: x is (B, R, L), perm (L,)")
  if x.device.type == "cpu":
    return permute_lanes_reference(x, perm)
  x = exp_pack._cuda_input("permute_lanes", x, 3, float4=True)
  b, r, l = x.shape
  _check_float4("permute_lanes", ("a row", l * 4))
  inv = _device_inverse(perm.detach().to("cpu", torch.int64).numpy()
                        .tobytes(), str(x.device))
  smem = lane_smem(l)
  check_smem("permute_lanes", KernelPlan(0, 256, smem), f"L {l}")
  out = torch.empty_like(x)
  if out.numel() == 0:
    return out
  _check_32bit("permute_lanes", b * r)
  with launch_stream(x.device) as stream:
    err = _kernel().tpu_splat_permute_lanes(x.data_ptr(), inv.data_ptr(),
                                            out.data_ptr(), b * r, l, smem,
                                            stream)
  _launched("permute_lanes", err)
  return out


# ---- the reference's probes, on their own inputs -------------------------

def probe_rows() -> np.ndarray:
  """V_a's and V_c's logical rows, (512, 16) f32 from the reference's
  seed; ``rows.reshape(64, 128)`` is their packed block."""
  return np.random.default_rng(0).random((512, 16)).astype(np.float32)


def probe_repeat_input() -> np.ndarray:
  """V_b's (8, 128) f32 block."""
  return np.arange(8 * 128, dtype=np.float32).reshape(8, 128)


def probe_gradient() -> np.ndarray:
  """V_p's (16, 512) f32 gradient-like values, over twelve decades."""
  return (np.random.default_rng(1).standard_normal((16, 512)) *
          10.0 ** np.random.default_rng(2).uniform(-6, 6, (16, 512))
          ).astype(np.float32)


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--device", default="cuda",
                      help="cuda (the default) or cpu (the plain twins)")
  parser.add_argument("--steps", type=int, default=12288,
                      help="T2's slabs (the reference's 12288)")
  args = parser.parse_args(argv)
  dev = torch.device(args.device)
  if dev.type == "cuda" and not torch.cuda.is_available():
    raise SystemExit("exp_pack2: CUDA is not available (use --device cpu "
                     "for the plain twins)")
  rows = probe_rows()
  xp = torch.as_tensor(rows.reshape(1, 64, 128), device=dev)
  ok = np.array_equal(permuted_unpack(xp, 16)[0].cpu().numpy(),
                      rows.T[:, perm_cprime()])
  print(f"V_a transpose+slice+concat (permuted): {'OK' if ok else 'WRONG'}")

  x = probe_repeat_input()
  out = repeat_rows(torch.as_tensor(x[None], device=dev), 2)[0].cpu().numpy()
  if np.array_equal(out, np.repeat(x, 2, axis=0)):
    print("V_b repeat_rows: ELEMENT semantics (np.repeat)")
  elif np.array_equal(out, np.tile(x, (2, 1))):
    print("V_b repeat_rows: TILE semantics (np.tile)")
  else:
    print("V_b repeat_rows: UNKNOWN semantics")

  ok = np.array_equal(unpack_direct(xp, 16)[0].cpu().numpy(), rows.T)
  print(f"V_c direct read (fetch order): {'OK' if ok else 'WRONG'}")

  g = probe_gradient()
  perm = torch.as_tensor(perm_cprime(), dtype=torch.int32)
  got = permute_lanes(torch.as_tensor(g[None], device=dev), perm)[0]
  inv = np.empty(512, np.int64)
  inv[perm_cprime()] = np.arange(512)
  want = g[:, inv]
  rel = np.abs(got.cpu().numpy() - want) / np.maximum(np.abs(want), 1e-30)
  print(f"V_p lane permute: rel_max={rel.max():.2e} "
        f"rel_p99={np.quantile(rel, 0.99):.2e}")

  steps, clock = args.steps, ("CUDA events" if dev.type == "cuda" else
                              "host clock, plain twins")
  x_flat = torch.zeros((steps * exp_pack.SLAB_ROWS, OUT_ROWS), device=dev)
  x_pack = torch.zeros((steps * SLAB_P, PACK * SLAB_W), device=dev)
  for name, fn in (
      ("today (512,12)T", lambda: exp_pack.slab_relayout(x_flat)),
      ("V_a", lambda: slab_relayout_permuted(x_pack)),
      ("V_c", lambda: exp_pack.slab_relayout(x_pack, packed=True))):
    ms = exp_pack.timed(fn, dev)
    ok = torch.equal(fn(), torch.zeros((OUT_ROWS, OUT_COLS), device=dev))
    print(f"T2 {name}: {ms:.2f} ms ({ms / steps * 1e3:.3f} us/slab)"
          f"{'' if ok else ' WRONG'} ({clock})")


if __name__ == "__main__":
  main()
