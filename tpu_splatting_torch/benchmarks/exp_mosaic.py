"""Data-movement probes: the counterpart of ``benchmarks/exp_mosaic.py``.

Four functions, each a hand-written kernel in ``csrc/exp_mosaic.cu`` with
a plain-torch twin.  Each takes a batch of offsets, so the reference's
probe (a batch of one, or three) and a measurement at scale run the same
function.  They lie on no product path: each answers a question that sets
a redesign of a kernel on it (``PERF.md``).

* ``dynamic_slice_rows`` (T1): ``out[b] = x[b, s_b : s_b + n]`` with
  ``lax.dynamic_slice``'s start, ``s_b = clamp(d_b + R [d_b < 0], 0,
  R - n)``: a negative start wraps by R before it clamps.  ``staged``
  picks the kernel that stages all of ``x[b]`` in shared memory, else it
  copies the window straight from device memory.
* ``reshape_rows`` (T2): ``(R, C) -> (R C / w, w)``, a new tensor; the
  kernel hands each thread one output row by warp shuffles and takes the
  rows back to coalesced stores the same way.
* ``double_block_window`` (T3): ``out[k] = x[src_k : src_k + g]`` from the
  two aligned g-row blocks the window straddles, fetched by bulk
  asynchronous copies; ``0 <= src_k < P - g``.
* ``dma_residue_sum`` (T4): ``out[b] = sum_{p=0..7} x[s_b : s_b + rows,
  16 p : 16 p + 16]`` added in p order; ``0 <= s_b <= R - rows``.  The
  kernel's persistent blocks each take the slabs that start in a range of
  rows, sort them, and stream their rows through a ring of shared memory,
  each needed row once a block (``residue_runs``, ``residue_chunks``),
  filled ahead by bulk asynchronous copies (``bulk``) or by per-thread
  asynchronous copies.

A CPU tensor goes to the ``*_reference`` twin, a CUDA tensor to the kernel
(built at first use; each launch counted in ``probe_launch_counts``), or
the call raises.  Where the reference raises (a window past the table),
the twins raise ValueError and the kernels trap.

    python -m tpu_splatting_torch.benchmarks.exp_mosaic [--device cpu]

prints the reference's four lines for the probes' own inputs, on the card
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..rasterizer.layout import _check
from ..utils.cuda_build import (KernelPlan, check_smem, launch_stream,
                                load_kernel_library)

# launches per wrapper; none lies on a product path
probe_launch_counts = {"dynamic_slice_rows": 0, "reshape_rows": 0,
                       "double_block_window": 0, "dma_residue_sum": 0}

RESIDUES, RESIDUE_W = 8, 16       # T4: 8 rows of 16 floats packed a row
RESHAPE_WIDTH = 16                # T2's kernel: rows of 16 floats
# csrc/exp_mosaic.cu: T2's tiles of 32 rows, kT2Unroll a warp and 8 warps a
# block; T4's ring (kT4Stages stages of kT4Chunk rows of 512 B and a
# chunk's sums), kT4Cap slabs a batch, and the persistent blocks a plan
# puts on each SM (their shared memory lets two fit)
T2_UNROLL = 2
T4_CHUNK_ROWS, T4_STAGES = 64, 3
T4_CAP = 256
BLOCKS_PER_SM = 2
# tpu_splat_mosaic_occupancy's kernel numbers
OCCUPANCY_KERNELS = {"T1 staged": 0, "T1 direct": 1, "T2": 2, "T3": 3,
                     "T4 bulk": 4, "T4 loads": 5}


def reset_launch_counts():
  for k in probe_launch_counts:
    probe_launch_counts[k] = 0


def reshape_plan(rows: int) -> int:
  """T2's blocks: one launch over the tiles of 32 rows, ``T2_UNROLL``
  tiles a warp and 8 warps a block."""
  return -(-rows // (32 * T2_UNROLL * 8))


class ResiduePlan(NamedTuple):
  """T4's launch: ``blocks`` blocks, block g taking the slabs that start
  in [g width, (g + 1) width); at most ``max_chunks`` chunks a batch of
  ``T4_CAP`` slabs; ``smem`` bytes a block."""
  blocks: int
  width: int
  max_chunks: int
  smem: int


def residue_plan(rows: int, r_rows: int, num_sms: int) -> ResiduePlan:
  """T4's plan for slabs of ``rows`` rows of an ``r_rows``-row table:
  persistent blocks over equal ranges of the starts [0, r_rows - rows].
  A batch's rows come in at most ``max_chunks`` chunks: a chunk ends at
  ``T4_CHUNK_ROWS`` rows or at a gap, each slab ends at most one gap and
  spans at most ceil(rows / T4_CHUNK_ROWS) full chunks.  Shared memory:
  the ring, a chunk's sums, a batch's sort keys, starts and slabs, the
  chunk list."""
  span = r_rows - rows + 1
  width = -(-span // min(span, BLOCKS_PER_SM * num_sms))
  max_chunks = T4_CAP * (1 + -(-rows // T4_CHUNK_ROWS))
  smem = (T4_STAGES * T4_CHUNK_ROWS * RESIDUES * RESIDUE_W * 4
          + T4_CHUNK_ROWS * RESIDUE_W * 4 + 16 * T4_CAP + 8 * max_chunks)
  return ResiduePlan(-(-span // width), width, max_chunks, smem)


def residue_runs(s: torch.Tensor, rows: int, r_rows: int,
                 num_sms: int) -> list:
  """The batches of ascending starts T4's blocks stream, block by block:
  block g's slabs (start in its range) in (start, slab) order, or, past
  ``T4_CAP`` of them, in batches of ``T4_CAP`` in slab order, each
  sorted."""
  plan = residue_plan(rows, r_rows, num_sms)
  s = s.cpu().long()
  out = []
  for g in range(plan.blocks):
    ids = torch.nonzero((s >= g * plan.width)
                        & (s < (g + 1) * plan.width)).flatten()
    for k in range(0, ids.numel(), T4_CAP):
      out.append(sorted(s[ids[k:k + T4_CAP]].tolist()))
  return out


def residue_chunks(starts, rows: int) -> list:
  """[(first row, rows)] a block of T4 streams for a run of ascending
  slab starts: the union of the slabs' rows, in order, each segment of
  it (slabs with no gap between them) cut into chunks of
  ``T4_CHUNK_ROWS`` rows from its first row (the kernel's own list, in
  plain Python)."""
  starts = [int(x) for x in starts]
  out, k = [], 0
  while k < len(starts):
    first, j = starts[k], k + 1
    while j < len(starts) and starts[j] <= starts[j - 1] + rows:
      j += 1
    end = starts[j - 1] + rows
    out += [(at, min(T4_CHUNK_ROWS, end - at))
            for at in range(first, end, T4_CHUNK_ROWS)]
    k = j
  return out


def residue_rows_read(s: torch.Tensor, rows: int, r_rows: int,
                      num_sms: int) -> int:
  """Table rows T4's blocks read for the starts ``s`` (``residue_runs``):
  each batch's union, so a row two batches share counts twice."""
  return sum(n for run in residue_runs(s, rows, r_rows, num_sms)
             for _, n in residue_chunks(run, rows))


def slice_starts(d: torch.Tensor, r: int, n: int) -> torch.Tensor:
  """``lax.dynamic_slice``'s start of an n-row window of r rows: wrap a
  negative d by r, then clamp to [0, r - n] (int64)."""
  d = d.long()
  return torch.clamp(torch.where(d < 0, d + r, d), 0, r - n)


def _check_starts(name: str, starts: torch.Tensor, hi: int, what: str):
  """ValueError unless every start lies in [0, hi]."""
  bad = (starts < 0) | (starts > hi)
  if bool(bad.any()):
    raise ValueError(f"{name}: starts {starts[bad][:4].tolist()} outside "
                     f"[0, {hi}] ({what})")


def dynamic_slice_rows_reference(x: torch.Tensor, d: torch.Tensor,
                                 n: int) -> torch.Tensor:
  """Plain-torch twin of ``dynamic_slice_rows``: one gather."""
  b, r, c = x.shape
  idx = slice_starts(d, r, n)[:, None] + torch.arange(n, device=x.device)
  return torch.gather(x, 1, idx[:, :, None].expand(b, n, c))


def reshape_rows_reference(x: torch.Tensor, w: int) -> torch.Tensor:
  """Plain-torch twin of ``reshape_rows``: a copy of the reshaped view."""
  return x.reshape(-1, w).clone()


def double_block_window_reference(x: torch.Tensor, src: torch.Tensor,
                                  g: int) -> torch.Tensor:
  """Plain-torch twin of ``double_block_window``: one gather of the
  windows, after the reference's range check."""
  _check_starts("double_block_window", src, x.shape[0] - g - 1,
                f"block src // {g} + 1 must lie in the table")
  idx = src.long()[:, None] + torch.arange(g, device=x.device)
  return x[idx]


def dma_residue_sum_reference(x: torch.Tensor, s: torch.Tensor,
                              rows: int = 64) -> torch.Tensor:
  """Plain-torch twin of ``dma_residue_sum``: a gather of the rows, then
  the residues added one at a time from 0, in p order."""
  _check_starts("dma_residue_sum", s, x.shape[0] - rows,
                f"the {rows} rows must lie in the table")
  slab = x[s.long()[:, None] + torch.arange(rows, device=x.device)]
  acc = torch.zeros((s.shape[0], rows, RESIDUE_W), dtype=x.dtype,
                    device=x.device)
  for p in range(RESIDUES):
    acc = acc + slab[..., RESIDUE_W * p:RESIDUE_W * (p + 1)]
  return acc


@functools.cache
def _kernel():
  lib = load_kernel_library("exp_mosaic.cu")
  vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
  for name, args in (
      ("tpu_splat_dynamic_slice_rows", [vp] * 3 + [i] * 5 + [ll, vp]),
      ("tpu_splat_reshape_rows", [vp, vp, ll, i, vp]),
      ("tpu_splat_double_block_window", [vp] * 3 + [i] * 4 + [ll, vp]),
      ("tpu_splat_dma_residue_sum", [vp] * 3 + [i] * 7 + [ll, vp]),
      ("tpu_splat_mosaic_occupancy", [i, ll, ctypes.POINTER(i)])):
    fn = getattr(lib, name)
    fn.restype = i
    fn.argtypes = args
  return lib


def occupancy(kernel: str, smem: int) -> dict:
  """Resident blocks and warps per SM, registers and local bytes of one
  probe kernel (``OCCUPANCY_KERNELS``) at 256 threads and ``smem`` bytes
  of dynamic shared memory."""
  out = (ctypes.c_int * 3)()
  err = _kernel().tpu_splat_mosaic_occupancy(OCCUPANCY_KERNELS[kernel], smem,
                                             out)
  if err != 0:
    raise RuntimeError(f"mosaic occupancy: CUDA error {err}")
  return {"blocks_per_sm": out[0], "warps_per_sm": out[0] * 8,
          "registers": out[1], "local_bytes": out[2]}


def _check_float4(name: str, *pairs):
  """The kernels move float4 units and bulk copies need 16-byte aligned
  addresses and sizes: ValueError otherwise, with the numbers."""
  for what, value in pairs:
    if value % 16:
      raise ValueError(f"{name} kernel: {what} is {value}, not a multiple "
                       "of 16 bytes")


def _cuda_inputs(name, x, offsets, x_dim):
  dev = x.device
  if dev.type != "cuda":
    raise ValueError(f"{name}: unsupported device {dev}")
  _check(f"{name} x", x, dev, (torch.float32,), x_dim)
  _check(f"{name} offsets", offsets, dev, (torch.int32,), 1)
  return x.contiguous(), offsets.contiguous()


def _launched(name, err):
  if err != 0:
    raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
  probe_launch_counts[name] += 1


def dynamic_slice_rows(x: torch.Tensor, d: torch.Tensor, n: int,
                       staged: bool = True) -> torch.Tensor:
  """(B, n, C): ``out[b] = x[b, s_b : s_b + n]``, ``s_b`` from
  ``slice_starts`` (x (B, R, C) f32, d (B,) int32; C a multiple of 4 on
  the card).  ``staged``: through shared memory (R C 4 bytes a block),
  else straight from device memory."""
  if x.dim() != 3 or not 0 < n <= x.shape[1]:
    raise ValueError(f"dynamic_slice_rows: x {tuple(x.shape)}, n {n}: "
                     "x is (B, R, C) and 0 < n <= R")
  if x.device.type == "cpu":
    return dynamic_slice_rows_reference(x, d, n)
  x, d = _cuda_inputs("dynamic_slice_rows", x, d, 3)
  b, r, c = x.shape
  if d.shape[0] != b:
    raise ValueError("dynamic_slice_rows: one offset per block of x")
  _check_float4("dynamic_slice_rows", ("a row", c * 4),
                ("x's address", x.data_ptr()))
  smem = r * c * 4 if staged else 0
  check_smem("dynamic_slice_rows (staged)", KernelPlan(0, 256, smem),
             f"R {r}, C {c}")
  out = torch.empty((b, n, c), dtype=x.dtype, device=x.device)
  if out.numel() == 0:
    return out
  with launch_stream(x.device) as stream:
    err = _kernel().tpu_splat_dynamic_slice_rows(
        x.data_ptr(), d.data_ptr(), out.data_ptr(), b, r, c // 4, n,
        int(staged), smem, stream)
  _launched("dynamic_slice_rows", err)
  return out


def _num_sms(dev) -> int:
  return torch.cuda.get_device_properties(dev).multi_processor_count


def reshape_rows(x: torch.Tensor, w: int) -> torch.Tensor:
  """(R C / w, w): the bytes of the (R, C) f32 ``x`` as rows of w, a new
  tensor (C % w == 0; w 16 on the card).  Each row passes through one
  thread's registers on its way: the kernel loads tiles of 32 rows
  coalesced, shuffles each row into one lane and back, and stores them
  coalesced (``reshape_plan``)."""
  if x.dim() != 2 or x.shape[1] % w:
    raise ValueError(f"reshape_rows: x {tuple(x.shape)}, w {w}: x is (R, C) "
                     "and w divides C")
  if x.device.type == "cpu":
    return reshape_rows_reference(x, w)
  if w != RESHAPE_WIDTH:
    raise ValueError(f"reshape_rows kernel: w {w}, it takes {RESHAPE_WIDTH}")
  dev = x.device
  if dev.type != "cuda":
    raise ValueError(f"reshape_rows: unsupported device {dev}")
  _check("reshape_rows x", x, dev, (torch.float32,), 2)
  x = x.contiguous()
  _check_float4("reshape_rows", ("x's address", x.data_ptr()))
  rows = x.numel() // w
  out = torch.empty((rows, w), dtype=x.dtype, device=dev)
  if rows == 0:
    return out
  with launch_stream(dev) as stream:
    err = _kernel().tpu_splat_reshape_rows(x.data_ptr(), out.data_ptr(), rows,
                                           reshape_plan(rows), stream)
  _launched("reshape_rows", err)
  return out


def double_block_window(x: torch.Tensor, src: torch.Tensor,
                        g: int) -> torch.Tensor:
  """(K, g, C): ``out[k] = x[src_k : src_k + g]`` for x (P, C) f32 with
  P % g == 0 and src (K,) int32 in [0, P - g).  The kernel fetches blocks
  src_k // g and src_k // g + 1 by bulk asynchronous copies (2 g C 4
  bytes of shared memory a block) and selects the window; a start outside
  the range traps on the device."""
  if x.dim() != 2 or g <= 0 or x.shape[0] % g:
    raise ValueError(f"double_block_window: x {tuple(x.shape)}, g {g}: x is "
                     "(P, C) with P a multiple of g")
  if x.device.type == "cpu":
    return double_block_window_reference(x, src, g)
  x, src = _cuda_inputs("double_block_window", x, src, 2)
  p, c = x.shape
  _check_float4("double_block_window", ("a block (g rows)", g * c * 4),
                ("a row", c * 4), ("x's address", x.data_ptr()))
  smem = 2 * g * c * 4
  check_smem("double_block_window", KernelPlan(0, 256, smem),
             f"g {g}, C {c}")
  out = torch.empty((src.shape[0], g, c), dtype=x.dtype, device=x.device)
  if out.numel() == 0:
    return out
  with launch_stream(x.device) as stream:
    err = _kernel().tpu_splat_double_block_window(
        x.data_ptr(), src.data_ptr(), out.data_ptr(), src.shape[0], p, g,
        c // 4, smem, stream)
  _launched("double_block_window", err)
  return out


def dma_residue_sum(x: torch.Tensor, s: torch.Tensor, rows: int = 64,
                    bulk: bool = True) -> torch.Tensor:
  """(B, rows, 16): the sum over the 8 residues p of ``x[s_b : s_b + rows,
  16 p : 16 p + 16]``, in p order, for x (R, 128) f32 and s (B,) int32 in
  [0, R - rows].  The kernel reads each needed row once a block
  (``residue_plan``, ``residue_chunks``), through a ring of shared memory
  filled by bulk asynchronous copies (``bulk``) or by per-thread ones; a
  start outside the range traps on the device."""
  width = RESIDUES * RESIDUE_W
  if x.dim() != 2 or x.shape[1] != width or not 0 < rows <= x.shape[0]:
    raise ValueError(f"dma_residue_sum: x {tuple(x.shape)}, rows {rows}: x "
                     f"is (R, {width}) and 0 < rows <= R")
  if x.device.type == "cpu":
    return dma_residue_sum_reference(x, s, rows)
  x, s = _cuda_inputs("dma_residue_sum", x, s, 2)
  _check_float4("dma_residue_sum", ("x's address", x.data_ptr()))
  b = s.shape[0]
  out = torch.empty((b, rows, RESIDUE_W), dtype=x.dtype, device=x.device)
  if out.numel() == 0:
    return out
  plan = residue_plan(rows, x.shape[0], _num_sms(x.device))
  check_smem("dma_residue_sum", KernelPlan(0, 256, plan.smem),
             f"slabs of {rows} rows")
  with launch_stream(x.device) as stream:
    err = _kernel().tpu_splat_dma_residue_sum(
        x.data_ptr(), s.data_ptr(), out.data_ptr(), b, x.shape[0], rows,
        int(bulk), plan.blocks, plan.width, plan.max_chunks, plan.smem,
        stream)
  _launched("dma_residue_sum", err)
  return out


# ---- the reference's probes, on their own inputs -------------------------

def probe_inputs(dev) -> dict:
  """The reference probes' inputs (``arange`` tables and their offsets)
  and, per probe, its ``expect`` as numpy computes it."""
  t1 = np.arange(256 * 16, dtype=np.float32).reshape(256, 16)
  t2 = np.arange(64 * 128, dtype=np.float32).reshape(64, 128)
  t3 = np.arange(1024 * 16, dtype=np.float32).reshape(1024, 16)
  t4 = np.arange(256 * 128, dtype=np.float32).reshape(256, 128)
  src = np.asarray([5, 200, 513], np.int32)
  on = functools.partial(torch.as_tensor, device=dev)
  return {
      "T1": ((on(t1)[None], on([37], dtype=torch.int32), 128),
             t1[37:37 + 128][None]),
      "T2": ((on(t2), 16), t2.reshape(512, 16)),
      "T3": ((on(t3), on(src), 128),
             np.stack([t3[s:s + 128] for s in src])),
      "T4": ((on(t4), on([19], dtype=torch.int32), 64),
             sum(t4[19:19 + 64, 16 * p:16 * (p + 1)]
                 for p in range(RESIDUES))[None]),
  }


# (label as the reference prints it, function, the kernel's instantiations)
PROBES = {
    "T1": ("T1 dynamic sublane slice", dynamic_slice_rows,
           ({"staged": True}, {"staged": False})),
    "T2": ("T2 contiguous reshape", reshape_rows, ({},)),
    "T3": ("T3 double-blockspec window", double_block_window, ({},)),
    "T4": ("T4 packed-row DMA + residue slices", dma_residue_sum,
           ({"bulk": True}, {"bulk": False})),
}


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--device", default="cuda",
                      help="cuda (the default) or cpu (the plain twins)")
  dev = torch.device(parser.parse_args(argv).device)
  if dev.type == "cuda" and not torch.cuda.is_available():
    raise SystemExit("exp_mosaic: CUDA is not available (use --device cpu "
                     "for the plain twins)")
  inputs = probe_inputs(dev)
  for key, (label, fn, variants) in PROBES.items():
    args, expect = inputs[key]
    try:
      ok = all(np.array_equal(fn(*args, **kw).cpu().numpy(), expect)
               for kw in (variants if dev.type == "cuda" else ({},)))
      print(f"{label}: {'OK' if ok else 'WRONG'}")
    except Exception as e:
      print(f"{fn.__name__} FAILED: {type(e).__name__}: {str(e)[:200]}")


if __name__ == "__main__":
  main()
