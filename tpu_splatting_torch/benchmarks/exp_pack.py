"""Packed-table probes: the counterpart of ``benchmarks/exp_pack.py``.

The stream table pads each row to ``w_pad`` >= 32 floats (128 B,
``rasterizer/stream.py``) where the headline's row holds 11.  These
probes measure what a narrower table costs to fetch and to re-lay: three
functions, each a hand-written kernel in ``csrc/exp_pack.cu`` with a
plain-torch twin.  Each takes a batch of blocks, so the reference's probe
and a measurement at scale run the same function.  They lie on no product
path (``PERF.md``).

* ``unpack_rows`` (U1, U1b, U2): ``xp`` (B, P, 8 w) holds 8 logical rows
  of w floats a packed row; the result (B, w, 8 P) has ``out[b, j, 8 p +
  k]`` = float j of logical row 8 p + k, which is ``xp[b, p, k w + j]``
  (``order="row"``) or ``xp[b, p, 8 j + k]`` (``order="col"``).
* ``slab_relayout`` (``t1_timing``): ``x`` is (S 512, C) slabs of 512 rows
  (C >= 12), or (S 64, 128) with ``packed``, the 512 rows of 16 floats of
  a slab packed 8 a row.  The result is the (12, 128) block of the LAST
  slab: its rows' first 12 floats, transposed, of its first 128 rows, as
  the reference's grid leaves it (every step overwrites the one output).
  The kernel still reads and re-lays every slab.
* ``column_sums`` (``f1_fetch``): (1, W), the column sums of the first
  ``(R // block_rows) * block_rows`` rows of x (R, W); the tail is not
  read.  The sums start from zero (the reference's kernel adds into an
  output that no step zeroes: ROADMAP F13) and the kernel's are
  deterministic: block sums, then added in a fixed order (contiguous
  ranges of blocks, each in block order, then the ranges in order).

A CPU tensor goes to the ``*_reference`` twin, a CUDA tensor to the kernel
(built at first use; each call counted in ``probe_launch_counts``), or the
call raises.

    python -m tpu_splatting_torch.benchmarks.exp_pack [--device cpu]
        [--steps S] [--n N]

prints the reference's lines for the probes' own inputs (U1, U1b and U2
``OK``; T1 and F1 with their times: by CUDA events on the card, by the
host clock of the twins with ``--device cpu``), on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import time

import numpy as np
import torch

from ..rasterizer.layout import _check
from ..utils.cuda_build import (KernelPlan, check_smem, launch_stream,
                                load_kernel_library)
from .exp_mosaic import _check_float4

# calls per wrapper; none lies on a product path
probe_launch_counts = {"unpack_rows": 0, "slab_relayout": 0,
                       "column_sums": 0}

PACK = 8                         # logical rows a packed row
SLAB_ROWS, PACKED_SLAB_ROWS = 512, 64
PACKED_WIDTH = 16                # slab_relayout packed: floats a row
OUT_ROWS, OUT_COLS = 12, 128     # slab_relayout's (12, 128) block
SLAB_STRIDE = SLAB_ROWS + 1      # the kernel's shared row stride
ORDERS = ("row", "col")
# tpu_splat_pack_occupancy's kernel numbers
OCCUPANCY_KERNELS = {"unpack_rows row": 0, "unpack_rows col": 1,
                     "slab_relayout flat": 2, "slab_relayout packed": 3,
                     "column_partials": 4}


def reset_launch_counts():
  for k in probe_launch_counts:
    probe_launch_counts[k] = 0


def unpack_smem(p: int, w: int) -> int:
  """Shared bytes of an unpack_rows block: 8 p logical rows at the odd
  stride w | 1."""
  return PACK * p * (w | 1) * 4


def slab_smem(c: int, packed: bool) -> int:
  """Shared bytes of a slab_relayout block: its columns at row stride
  513."""
  return (PACKED_WIDTH if packed else c) * SLAB_STRIDE * 4


def unpack_rows_reference(xp: torch.Tensor, w: int,
                          order: str = "row") -> torch.Tensor:
  """Plain-torch twin of ``unpack_rows``: a reshape and a transpose."""
  b, p, _ = xp.shape
  if order == "row":
    return xp.reshape(b, PACK * p, w).transpose(1, 2).clone(
        memory_format=torch.contiguous_format)
  return xp.reshape(b, p, w, PACK).permute(0, 2, 1, 3).reshape(b, w, PACK * p)


def slab_relayout_reference(x: torch.Tensor,
                            packed: bool = False) -> torch.Tensor:
  """Plain-torch twin of ``slab_relayout``: the last slab's rows,
  transposed, cut to (12, 128)."""
  if packed:
    rows = x[-PACKED_SLAB_ROWS:].reshape(SLAB_ROWS, PACKED_WIDTH)
  else:
    rows = x[-SLAB_ROWS:]
  return rows.T[:OUT_ROWS, :OUT_COLS].contiguous()


def column_sums_reference(x: torch.Tensor, block_rows: int) -> torch.Tensor:
  """Plain-torch twin of ``column_sums``: block sums of the covered rows,
  then their sum, from zero."""
  g = x.shape[0] // block_rows
  blocks = x[:g * block_rows].reshape(g, block_rows, x.shape[1])
  return blocks.sum(1).sum(0, keepdim=True)


@functools.cache
def _kernel():
  lib = load_kernel_library("exp_pack.cu")
  vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
  for name, args in (
      ("tpu_splat_unpack_rows", [vp, vp] + [i] * 4 + [ll, vp]),
      ("tpu_splat_slab_relayout", [vp, vp] + [i] * 3 + [ll, vp]),
      ("tpu_splat_column_sums", [vp] * 3 + [i] * 3 + [vp]),
      ("tpu_splat_pack_occupancy", [i, ll, ctypes.POINTER(i)])):
    fn = getattr(lib, name)
    fn.restype = i
    fn.argtypes = args
  return lib


def occupancy(kernel: str, smem: int) -> dict:
  """Resident blocks and warps per SM, registers and local bytes of one
  probe kernel (``OCCUPANCY_KERNELS``) at 256 threads and ``smem`` bytes
  of dynamic shared memory."""
  out = (ctypes.c_int * 3)()
  err = _kernel().tpu_splat_pack_occupancy(OCCUPANCY_KERNELS[kernel], smem,
                                           out)
  if err != 0:
    raise RuntimeError(f"pack occupancy: CUDA error {err}")
  return {"blocks_per_sm": out[0], "warps_per_sm": out[0] * 8,
          "registers": out[1], "local_bytes": out[2]}


def _cuda_input(name: str, x: torch.Tensor, dim: int,
                float4: bool) -> torch.Tensor:
  """x checked for the kernel (CUDA, f32, ``dim`` dimensions) and made
  contiguous; ``float4``: its address a multiple of 16 bytes."""
  dev = x.device
  if dev.type != "cuda":
    raise ValueError(f"{name}: unsupported device {dev}")
  _check(f"{name} x", x, dev, (torch.float32,), dim)
  x = x.contiguous()
  if float4:
    _check_float4(name, ("x's address", x.data_ptr()))
  return x


def _launched(name, err):
  if err != 0:
    raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
  probe_launch_counts[name] += 1


def unpack_rows(xp: torch.Tensor, w: int, order: str = "row") -> torch.Tensor:
  """(B, w, 8 P) from (B, P, 8 w) f32 packed 8 logical rows a row,
  ``order`` "row" (row-major within the packed row) or "col"
  (column-major).  The kernel stages each block in shared memory
  (``unpack_smem`` bytes)."""
  if xp.dim() != 3 or w <= 0 or xp.shape[2] != PACK * w or order not in ORDERS:
    raise ValueError(f"unpack_rows: xp {tuple(xp.shape)}, w {w}, order "
                     f"{order!r}: xp is (B, P, 8 w), order one of {ORDERS}")
  if xp.device.type == "cpu":
    return unpack_rows_reference(xp, w, order)
  xp = _cuda_input("unpack_rows", xp, 3, float4=True)
  b, p, _ = xp.shape
  smem = unpack_smem(p, w)
  check_smem("unpack_rows", KernelPlan(0, 256, smem), f"P {p}, w {w}")
  out = torch.empty((b, w, PACK * p), dtype=xp.dtype, device=xp.device)
  if out.numel() == 0:
    return out
  with launch_stream(xp.device) as stream:
    err = _kernel().tpu_splat_unpack_rows(xp.data_ptr(), out.data_ptr(), b, p,
                                          w, int(order == "col"), smem,
                                          stream)
  _launched("unpack_rows", err)
  return out


def slab_relayout(x: torch.Tensor, packed: bool = False) -> torch.Tensor:
  """(12, 128): the last slab's block of x, (S 512, C) f32 with C >= 12,
  or (S 64, 128) with ``packed``.  The kernel reads and re-lays every
  slab in shared memory (``slab_smem`` bytes a block); the last slab's
  block writes the result."""
  rows = PACKED_SLAB_ROWS if packed else SLAB_ROWS
  if packed:
    fits = x.dim() == 2 and x.shape[1] == PACK * PACKED_WIDTH
  else:
    fits = x.dim() == 2 and x.shape[1] >= OUT_ROWS
  if not fits or x.shape[0] == 0 or x.shape[0] % rows:
    want = (f"(S {rows}, {PACK * PACKED_WIDTH})" if packed else
            f"(S {rows}, C >= {OUT_ROWS})")
    raise ValueError(f"slab_relayout: x {tuple(x.shape)}, packed {packed}: "
                     f"x is {want}, S > 0")
  if x.device.type == "cpu":
    return slab_relayout_reference(x, packed)
  x = _cuda_input("slab_relayout", x, 2, float4=True)
  c = x.shape[1]
  smem = slab_smem(c, packed)
  check_smem("slab_relayout", KernelPlan(0, 256, smem), f"C {c}")
  out = torch.empty((OUT_ROWS, OUT_COLS), dtype=x.dtype, device=x.device)
  with launch_stream(x.device) as stream:
    err = _kernel().tpu_splat_slab_relayout(x.data_ptr(), out.data_ptr(),
                                            x.shape[0] // rows, c,
                                            int(packed), smem, stream)
  _launched("slab_relayout", err)
  return out


def column_sums(x: torch.Tensor, block_rows: int) -> torch.Tensor:
  """(1, W): the column sums, from zero, of the first ``(R // block_rows)
  * block_rows`` rows of x (R, W) f32.  The kernel sums each block of
  rows, then adds the block sums in a fixed order: two runs agree bit for
  bit."""
  if x.dim() != 2 or block_rows <= 0:
    raise ValueError(f"column_sums: x {tuple(x.shape)}, block_rows "
                     f"{block_rows}: x is (R, W) and block_rows > 0")
  if x.device.type == "cpu":
    return column_sums_reference(x, block_rows)
  x = _cuda_input("column_sums", x, 2, float4=False)
  g, w = x.shape[0] // block_rows, x.shape[1]
  if g == 0 or w == 0:
    return torch.zeros((1, w), dtype=x.dtype, device=x.device)
  out = torch.empty((1, w), dtype=x.dtype, device=x.device)
  partial = torch.empty((g, w), dtype=x.dtype, device=x.device)
  with launch_stream(x.device) as stream:
    err = _kernel().tpu_splat_column_sums(x.data_ptr(), partial.data_ptr(),
                                          out.data_ptr(), g, block_rows, w,
                                          stream)
  _launched("column_sums", err)
  return out


# ---- the reference's probes, on their own inputs -------------------------

def unpack_inputs(dev) -> dict:
  """{probe: (label as the reference prints it, (xp, w, order), expect)}:
  U1, U1b and U2's packed tables (a batch of one) from the reference's
  seed, and ``x.T`` as numpy computes it."""
  out = {}
  for key, label, w, order in (
      ("U1", "U1 w_pad16 reshape+transpose", 16, "row"),
      ("U1b", "U1b rowmajor w=11", 11, "row"),
      ("U2", "U2 colmajor 3d-transpose", 12, "col")):
    x = np.random.default_rng(0).random((512, w)).astype(np.float32)
    xp = (x.reshape(64, PACK * w) if order == "row" else
          x.reshape(64, PACK, w).transpose(0, 2, 1).reshape(64, PACK * w))
    out[key] = (label, (torch.as_tensor(xp, device=dev)[None], w, order),
                x.T[None])
  return out


def timed(fn, dev, iters=20) -> float:
  """ms a call of fn(): CUDA events over ``iters`` calls on the card, the
  host clock on the CPU; after one warm-up call."""
  fn()
  if dev.type == "cuda":
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
      fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
  t0 = time.perf_counter()
  for _ in range(iters):
    fn()
  return (time.perf_counter() - t0) / iters * 1e3


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--device", default="cuda",
                      help="cuda (the default) or cpu (the plain twins)")
  parser.add_argument("--steps", type=int, default=12288,
                      help="T1's slabs (the reference's 12288)")
  parser.add_argument("--n", type=int, default=2_000_000,
                      help="F1's table rows (the reference's 2,000,000)")
  args = parser.parse_args(argv)
  dev = torch.device(args.device)
  if dev.type == "cuda" and not torch.cuda.is_available():
    raise SystemExit("exp_pack: CUDA is not available (use --device cpu for "
                     "the plain twins)")
  for label, (xp, w, order), expect in unpack_inputs(dev).values():
    try:
      ok = np.array_equal(unpack_rows(xp, w, order).cpu().numpy(), expect)
      print(f"{label}: {'OK' if ok else 'WRONG'}")
    except Exception as e:
      print(f"{label}: FAILED {type(e).__name__}: {str(e)[:200]}")

  steps, clock = args.steps, ("CUDA events" if dev.type == "cuda" else
                              "host clock, plain twins")
  x_flat = torch.zeros((steps * SLAB_ROWS, OUT_ROWS), device=dev)
  x_pack = torch.zeros((steps * PACKED_SLAB_ROWS, PACK * PACKED_WIDTH),
                       device=dev)
  ok = all(torch.equal(slab_relayout(x, p), slab_relayout_reference(x, p))
           for x, p in ((x_flat, False), (x_pack, True)))
  ms_t = timed(lambda: slab_relayout(x_flat), dev)
  ms_u = timed(lambda: slab_relayout(x_pack, packed=True), dev)
  print(f"T1 {steps} slabs: transpose-only {ms_t:.2f} ms "
        f"({ms_t / steps * 1e3:.3f} us/slab), unpack+transpose "
        f"{ms_u:.2f} ms ({ms_u / steps * 1e3:.3f} us/slab)"
        f"{'' if ok else ' WRONG'} ({clock})")
  print(f"   NOTE transpose-only fetched unpadded (512, 12) blocks: "
        f"{x_flat.numel() * 4 / 1e9:.2f} GB vs packed "
        f"{x_pack.numel() * 4 / 1e9:.2f} GB")
  del x_flat, x_pack

  n, s_cap = args.n, 1024
  g = n // s_cap
  x_flat = torch.zeros((n, OUT_ROWS), device=dev)
  x_pack = torch.zeros((n // PACK, OUT_COLS), device=dev)
  ok = all(torch.equal(column_sums(x, r), torch.zeros_like(x[:1]))
           for x, r in ((x_flat, s_cap), (x_pack, s_cap // PACK)))
  ms_f = timed(lambda: column_sums(x_flat, s_cap), dev)
  ms_p = timed(lambda: column_sums(x_pack, s_cap // PACK), dev)
  gb_f = g * s_cap * OUT_ROWS * 4 / 1e9
  gb_p = g * (s_cap // PACK) * OUT_COLS * 4 / 1e9
  print(f"F1 one table pass ({g} blocks): flat {ms_f:.2f} ms "
        f"({gb_f / ms_f * 1e3:.0f} GB/s of {gb_f:.2f} GB), packed "
        f"{ms_p:.2f} ms ({gb_p / ms_p * 1e3:.0f} GB/s of {gb_p:.2f} GB)"
        f"{'' if ok else ' WRONG'} ({clock})")


if __name__ == "__main__":
  main()
