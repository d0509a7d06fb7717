"""Data-movement kernels of the sorted pipeline, and their plain twins.

Counterpart of ``tpu_splatting/rasterizer/layout.py``.

* ``window_copy`` (K6): lay the tile-sorted overlap rows out chunk-aligned,
  ``out[k*g + r] = rows[chunk_src[k] + r]`` if ``r < chunk_cnt[k]`` else 0.
  A bit copy, so it takes int32 ids as well as float rows.
* ``segment_sum_sorted`` (K7): per-id sum of id-sorted rows; rows whose id
  is >= ``num_segments`` are dropped.  Given ``order`` (the int64
  permutation that sorted the ids), sorted row i is ``rows[order[i]]``,
  read inside the kernel: the reference's caller sorts the rows as
  payload, the port sorts the ids alone and gathers here.
* ``row_gather``: ``out[i] = table[idx[i]]``, 0 where ``idx[i]`` is outside
  the table; the counterpart of the gather probes of
  ``benchmarks/exp_gather.py``, on no product path (counted in
  ``probe_launch_counts``).

The reference packs narrow rows 8 to a 128-lane super-row (at most 15
columns, ids carried by value in f32) and, for f32 rows on the TPU, sums
them with a bf16 one-hot matmul.  Those are TPU residuals: the port takes
any column count, int32 ids, and sums in exact f32 (or f64), the result
the reference's interpret mode gives.

A CUDA tensor goes to the hand-written kernels in ``csrc/layout.cu``
(built at first use; each launch counted in ``launch_counts``), a CPU
tensor to the ``*_reference`` twin.  There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..utils.cuda_build import launch_stream, load_kernel_library

# kernel launches per wrapper; only the wrapper's launch site adds to it
launch_counts = {"window_copy": 0, "segment_sum_sorted": 0}
# launches of the probe, which lies on no product path
probe_launch_counts = {"row_gather": 0}


def reset_launch_counts():
  for counts in (launch_counts, probe_launch_counts):
    for k in counts:
      counts[k] = 0


def window_copy_reference(rows: torch.Tensor, chunk_src: torch.Tensor,
                          chunk_cnt: torch.Tensor, g: int) -> torch.Tensor:
  """Plain-torch twin of ``window_copy``: one gather + mask."""
  r = torch.arange(g, device=rows.device)
  idx = chunk_src.long()[:, None] + r
  valid = r < chunk_cnt[:, None]
  idx = torch.where(valid, idx, 0).reshape(-1)
  out = rows[idx]
  return torch.where(valid.reshape(-1, *([1] * (rows.dim() - 1))), out,
                     torch.zeros((), dtype=rows.dtype, device=rows.device))


def segment_sum_sorted_reference(rows: torch.Tensor, ids: torch.Tensor,
                                 num_segments: int,
                                 order: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
  """Plain-torch twin of ``segment_sum_sorted`` (any id order)."""
  if order is not None:
    rows = rows[order]
  keep = (ids >= 0) & (ids < num_segments)
  out = torch.zeros((num_segments + 1, rows.shape[1]), dtype=rows.dtype,
                    device=rows.device)
  out.index_add_(0, torch.where(keep, ids.long(), num_segments), rows)
  return out[:num_segments]


def row_gather_reference(table: torch.Tensor,
                         idx: torch.Tensor) -> torch.Tensor:
  """Plain-torch twin of ``row_gather``: torch indexing, then 0 where the
  index lies outside the table."""
  n = table.shape[0]
  valid = (idx >= 0) & (idx < n)
  out = table[torch.where(valid, idx.long(), 0)] if n else table.new_zeros(
      (idx.shape[0], *table.shape[1:]))
  return torch.where(valid.reshape(-1, *([1] * (table.dim() - 1))), out,
                     torch.zeros((), dtype=table.dtype, device=table.device))


@functools.cache
def _kernel():
  lib = load_kernel_library("layout.cu")
  lib.tpu_splat_window_copy.restype = ctypes.c_int
  lib.tpu_splat_window_copy.argtypes = (
      [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
  lib.tpu_splat_segment_sum_sorted.restype = ctypes.c_int
  lib.tpu_splat_segment_sum_sorted.argtypes = (
      [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
  lib.tpu_splat_row_gather.restype = ctypes.c_int
  lib.tpu_splat_row_gather.argtypes = (
      [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
      + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
  lib.tpu_splat_layout_occupancy.restype = ctypes.c_int
  lib.tpu_splat_layout_occupancy.argtypes = (
      [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)])
  return lib


def _check(name, x, dev, dtypes, dim):
  if x.device != dev:
    raise ValueError(f"{name}: tensor on {x.device}, expected {dev}")
  if x.dtype not in dtypes:
    raise TypeError(f"{name}: dtype {x.dtype} not in {dtypes}")
  if x.dim() != dim:
    raise ValueError(f"{name}: expected {dim} dimensions, got "
                     f"{tuple(x.shape)}")


def check_window_copy_range(k: int, g: int, c: int, m: int):
  """The window-copy kernel indexes in 32 bits: raise ValueError unless
  the k*g*c output elements and the m*c elements of ``rows`` are each
  below 2^31."""
  if k * g * c >= 2 ** 31 or m * c >= 2 ** 31:
    raise ValueError(f"window_copy kernel: {k} windows of {g} x {c} from "
                     f"{m} rows exceed 32-bit element indices")


def window_copy(rows: torch.Tensor, chunk_src: torch.Tensor,
                chunk_cnt: torch.Tensor, g: int) -> torch.Tensor:
  """out[k*g + r] = rows[chunk_src[k] + r] if r < chunk_cnt[k] else 0.

  ``rows`` is (M, C) (or (M,)); every window must lie inside it (the
  mapper pads its sorted buffers with two chunks of slack).  CPU tensors
  go to ``window_copy_reference``, CUDA tensors to the ``csrc/layout.cu``
  kernel (4- and 8-byte elements, copied bit for bit; a window outside
  ``rows`` faults on the device)."""
  dev = rows.device
  if dev.type == "cpu":
    return window_copy_reference(rows, chunk_src, chunk_cnt, g)
  if dev.type != "cuda":
    raise ValueError(f"window_copy: unsupported device {dev}")
  if rows.dim() not in (1, 2) or rows.element_size() not in (4, 8):
    raise TypeError(f"window_copy: rows {tuple(rows.shape)} {rows.dtype}: "
                    "1-D or 2-D of 4- or 8-byte elements")
  for name, x in (("chunk_src", chunk_src), ("chunk_cnt", chunk_cnt)):
    _check(f"window_copy {name}", x, dev, (torch.int32,), 1)
  if chunk_src.shape != chunk_cnt.shape:
    raise ValueError("window_copy: chunk_src and chunk_cnt differ in shape")
  k = chunk_src.shape[0]
  m = rows.shape[0]
  c = rows.shape[1] if rows.dim() == 2 else 1
  check_window_copy_range(k, g, c, m)
  rows = rows.contiguous()
  chunk_src, chunk_cnt = chunk_src.contiguous(), chunk_cnt.contiguous()
  out = torch.empty((k * g, *rows.shape[1:]), dtype=rows.dtype, device=dev)
  if out.numel() == 0:
    return out
  with launch_stream(dev) as stream:
    err = _kernel().tpu_splat_window_copy(
        rows.data_ptr(), chunk_src.data_ptr(), chunk_cnt.data_ptr(),
        out.data_ptr(), k, g, c, m, rows.element_size(), stream)
  if err != 0:
    raise RuntimeError(f"window_copy kernel launch failed: CUDA error {err}")
  launch_counts["window_copy"] += 1
  return out


# the sum kernels index sorted positions, and the bounds hold them, in 32
# bits (the bounds pass runs one thread past the last position per block)
MAX_SORTED_ROWS = 2 ** 31 - 1024


def segment_sum_sorted(rows: torch.Tensor, ids: torch.Tensor,
                       num_segments: int,
                       order: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Sum rows by id, ids sorted ascending: (num_segments, C).  Rows with
  id >= num_segments are dropped (sentinel padding).  With ``order``
  (int64, one entry per id, as ``torch.sort`` returns it), sorted row i is
  ``rows[order[i]]``; without it, ``rows[i]``.  Every entry of ``order`` must index ``rows``
  (on the device, one that does not faults, as torch indexing asserts).

  CPU tensors go to ``segment_sum_sorted_reference``; CUDA tensors to the
  ``csrc/layout.cu`` kernels: a pass over the sorted ids writes each
  segment's bounds, then each segment's rows are gathered through
  ``order`` and summed in sorted order (exact f32 / f64, deterministic,
  and bit for bit the call on ``rows[order]`` without ``order``)."""
  dev = rows.device
  if dev.type == "cpu":
    return segment_sum_sorted_reference(rows, ids, num_segments, order)
  if dev.type != "cuda":
    raise ValueError(f"segment_sum_sorted: unsupported device {dev}")
  _check("segment_sum_sorted rows", rows, dev,
         (torch.float32, torch.float64), 2)
  _check("segment_sum_sorted ids", ids, dev, (torch.int32,), 1)
  m, c = ids.shape[0], rows.shape[1]
  if order is None:
    if rows.shape[0] != m:
      raise ValueError("segment_sum_sorted: one id per row")
  else:
    _check("segment_sum_sorted order", order, dev, (torch.int64,), 1)
    if order.shape[0] != m:
      raise ValueError("segment_sum_sorted: one order entry per id")
  if m > MAX_SORTED_ROWS or num_segments >= 2 ** 31 - 1:
    raise ValueError(f"segment_sum_sorted kernel: {m} sorted rows or "
                     f"{num_segments} segments exceed 32-bit positions")
  rows, ids = rows.contiguous(), ids.contiguous()
  out = torch.empty((num_segments, c), dtype=rows.dtype, device=dev)
  if out.numel() == 0:
    return out
  order_ptr = None
  if order is not None:
    order = order.contiguous()
    order_ptr = order.data_ptr()
  bounds = torch.empty(num_segments + 1, dtype=torch.int32, device=dev)
  with launch_stream(dev) as stream:
    err = _kernel().tpu_splat_segment_sum_sorted(
        rows.data_ptr(), ids.data_ptr(), order_ptr, bounds.data_ptr(),
        out.data_ptr(), m, num_segments, c, rows.element_size(), stream)
  if err != 0:
    raise RuntimeError(f"segment_sum_sorted kernel launch failed: CUDA "
                       f"error {err}")
  launch_counts["segment_sum_sorted"] += 1
  return out


def row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
  """out[i] = table[idx[i]] where 0 <= idx[i] < len(table), else 0.

  ``table`` is (n, C) (or (n,)) of 4- or 8-byte elements, copied bit for
  bit; ``idx`` is 1-D int32 or int64.  CPU tensors go to
  ``row_gather_reference``, CUDA tensors to the ``csrc/layout.cu`` kernel.
  A probe: the product path gathers inside ``segment_sum_sorted``."""
  dev = table.device
  if dev.type == "cpu":
    return row_gather_reference(table, idx)
  if dev.type != "cuda":
    raise ValueError(f"row_gather: unsupported device {dev}")
  if table.dim() not in (1, 2) or table.element_size() not in (4, 8):
    raise TypeError(f"row_gather: table {tuple(table.shape)} {table.dtype}: "
                    "1-D or 2-D of 4- or 8-byte elements")
  _check("row_gather idx", idx, dev, (torch.int32, torch.int64), 1)
  table, idx = table.contiguous(), idx.contiguous()
  out = torch.empty((idx.shape[0], *table.shape[1:]), dtype=table.dtype,
                    device=dev)
  if out.numel() == 0:
    return out
  row_bytes = table.element_size() * (table.shape[1] if table.dim() == 2
                                      else 1)
  with launch_stream(dev) as stream:
    err = _kernel().tpu_splat_row_gather(
        table.data_ptr(), idx.data_ptr(), idx.element_size(), out.data_ptr(),
        idx.shape[0], table.shape[0], row_bytes, table.element_size(),
        stream)
  if err != 0:
    raise RuntimeError(f"row_gather kernel launch failed: CUDA error {err}")
  probe_launch_counts["row_gather"] += 1
  return out
