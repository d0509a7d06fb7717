"""Data-movement kernels of the sorted pipeline, and their plain twins.

Counterpart of ``tpu_splatting/rasterizer/layout.py``.

* ``window_copy`` (K6): lay the tile-sorted overlap rows out chunk-aligned,
  ``out[k*g + r] = rows[chunk_src[k] + r]`` if ``r < chunk_cnt[k]`` else 0.
  A bit copy, so it takes int32 ids as well as float rows.
* ``segment_sum_sorted`` (K7): per-id sum of id-sorted rows; rows whose id
  is >= ``num_segments`` are dropped.

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

import torch

from ..utils.cuda_build import launch_stream, load_kernel_library

# kernel launches per wrapper; only the wrapper's launch site adds to it
launch_counts = {"window_copy": 0, "segment_sum_sorted": 0}


def reset_launch_counts():
  for k in launch_counts:
    launch_counts[k] = 0


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
                                 num_segments: int) -> torch.Tensor:
  """Plain-torch twin of ``segment_sum_sorted`` (any id order)."""
  keep = (ids >= 0) & (ids < num_segments)
  out = torch.zeros((num_segments + 1, rows.shape[1]), dtype=rows.dtype,
                    device=rows.device)
  out.index_add_(0, torch.where(keep, ids.long(), num_segments), rows)
  return out[:num_segments]


@functools.cache
def _kernel():
  lib = load_kernel_library("layout.cu")
  lib.tpu_splat_window_copy.restype = ctypes.c_int
  lib.tpu_splat_window_copy.argtypes = (
      [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
  lib.tpu_splat_segment_sum_sorted.restype = ctypes.c_int
  lib.tpu_splat_segment_sum_sorted.argtypes = (
      [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
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


def segment_sum_sorted(rows: torch.Tensor, ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
  """Sum rows by id, ids sorted ascending: (num_segments, C).  Rows with
  id >= num_segments are dropped (sentinel padding).

  CPU tensors go to ``segment_sum_sorted_reference``; CUDA tensors to the
  ``csrc/layout.cu`` kernel: the segments' bounds come from one
  ``searchsorted`` over the ids, and a warp sums each segment's rows in
  order (exact f32 / f64, deterministic)."""
  dev = rows.device
  if dev.type == "cpu":
    return segment_sum_sorted_reference(rows, ids, num_segments)
  if dev.type != "cuda":
    raise ValueError(f"segment_sum_sorted: unsupported device {dev}")
  _check("segment_sum_sorted rows", rows, dev,
         (torch.float32, torch.float64), 2)
  _check("segment_sum_sorted ids", ids, dev, (torch.int32,), 1)
  if ids.shape[0] != rows.shape[0]:
    raise ValueError("segment_sum_sorted: one id per row")
  rows, ids = rows.contiguous(), ids.contiguous()
  m, c = rows.shape
  out = torch.empty((num_segments, c), dtype=rows.dtype, device=dev)
  if out.numel() == 0:
    return out
  bounds = torch.searchsorted(
      ids, torch.arange(num_segments + 1, dtype=torch.int32, device=dev),
      side="left", out_int32=True)
  with launch_stream(dev) as stream:
    err = _kernel().tpu_splat_segment_sum_sorted(
        rows.data_ptr(), bounds.data_ptr(), out.data_ptr(), num_segments, c,
        rows.element_size(), stream)
  if err != 0:
    raise RuntimeError(f"segment_sum_sorted kernel launch failed: CUDA "
                       f"error {err}")
  launch_counts["segment_sum_sorted"] += 1
  return out
