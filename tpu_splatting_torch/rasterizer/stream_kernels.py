"""Stream forward rasterization: the CUDA kernel K1 and its plain twin.

Counterpart of the forward half of ``tpu_splatting/rasterizer/
stream_kernels.py``.  ``stream_forward`` takes a ``StreamMapping`` and
returns the (T, F+1, tile_area) tiled image; channel F is the alpha
(weight) image in blending mode and the hit mask in quantile mode.

* A mapping on a CUDA device goes to the hand-written Hopper kernel
  ``csrc/stream_forward.cu`` (built at first use); the wrapper checks
  shapes and types, launches on the current stream, raises on a launch
  error and counts the launch in ``launch_counts``.
* A mapping on the CPU goes to ``stream_forward_reference``, the same
  function in plain torch.  There is no fallback between the two.

The reference's ``ablate`` and ``with_counts`` instruments, ``band0``
(band sharding, ROADMAP P13) and ``with_asm`` (a TPU-only residual) are
not ported.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..data_types import RasterConfig
from .stream import STRIP_SLACK, StreamMapping

_NEG_BIG = -3.0e38

# kernel launches per wrapper; only the wrapper's launch site adds to it
launch_counts = {"stream_forward": 0}


def reset_launch_counts():
  for k in launch_counts:
    launch_counts[k] = 0


def slab_width(config: RasterConfig, f: int) -> int:
  """Columns of the backward's per-row gradient slab: 7 packed-gaussian
  grads + F feature grads [+ visibility] [+ prune_cost, split_score]."""
  heur = config.compute_point_heuristic
  with_vis = heur or config.compute_visibility
  return 7 + f + (1 if with_vis else 0) + (2 if heur else 0)


def _log_cut(config: RasterConfig) -> float:
  """Freeze / skip threshold on the log transmittance."""
  if config.use_alpha_blending:
    cut = 1.0 - config.saturate_threshold
    return math.log(cut) if cut > 0.0 else _NEG_BIG
  thr = config.saturate_threshold
  return math.log(thr) if thr > 0.0 else _NEG_BIG


def _window_slots(mapping: StreamMapping):
  """(slot0, len, row0), each (T, S, W): the assembly slot of each
  window's first row, its length after the slab-capacity clamp against
  the rpb-quantized cursor (reference ``_assemble``), and its first
  global table row."""
  t, s, w = mapping.num_tiles, mapping.num_slabs, mapping.w_max
  rpb = mapping.rows_per_block
  desc = mapping.desc.view(t, s, w, 4).to(torch.int64)
  lo, ln, band = desc[..., 0], desc[..., 1], desc[..., 3] // 3
  sb = mapping.strip_blk.to(torch.int64)[
      torch.arange(t, device=desc.device) // mapping.group_width]
  stride = 2 * mapping.strip_cap + STRIP_SLACK
  row0 = (torch.gather(sb[:, None, :].expand(t, s, 3), 2, band)
          * mapping.strip_cap + lo - band * stride)
  head = lo % rpb
  cur = torch.zeros((t, s), dtype=torch.int64, device=desc.device)
  slot0, lnc = torch.empty_like(lo), torch.empty_like(lo)
  for k in range(w):
    l_k = torch.clamp(torch.minimum(
        ln[..., k], mapping.slab_cap - (cur + head[..., k])), min=0)
    slot0[..., k] = cur + head[..., k]
    lnc[..., k] = l_k
    cur = cur + torch.where(l_k > 0, (head[..., k] + l_k + rpb - 1)
                            // rpb * rpb, 0)
  return slot0, lnc, row0


def _alpha(rows, ox, oy, pxl, pyl, config: RasterConfig):
  """(C, L, PIX) thresholded + clamped alpha of rows (C, L, >=7) at the
  tile-centred pixel coordinates, the reference forward's formulas."""
  mlx = (rows[..., 0] - ox)[..., None]
  mly = (rows[..., 1] - oy)[..., None]
  ax, ay = rows[..., 2, None], rows[..., 3, None]
  sx, sy, pa = rows[..., 4, None], rows[..., 5, None], rows[..., 6, None]
  if config.antialias:
    tu = ax * pxl + ay * pyl + (-(mlx * ax + mly * ay))
    tv = -ay * pxl + ax * pyl + (mlx * ay - mly * ax)
    sxc = torch.clamp(sx, min=1e-12)
    syc = torch.clamp(sy, min=1e-12)

    def s_sig(x, s):
      z = x / s
      return 1.0 / (1.0 + torch.exp(-1.6 * z - 0.07 * z * z * z))

    ix = sxc * (s_sig(tu + 0.5, sxc) - s_sig(tu - 0.5, sxc))
    iy = syc * (s_sig(tv + 0.5, syc) - s_sig(tv - 0.5, syc))
    a_raw = pa * (2.0 * math.pi * ix * iy)
  else:
    isx2 = 1.0 / torch.clamp(sx * sx, min=1e-24)
    isy2 = 1.0 / torch.clamp(sy * sy, min=1e-24)
    a2, b2 = ax * ax, ay * ay
    cxx = -0.5 * (a2 * isx2 + b2 * isy2)
    cyy = -0.5 * (b2 * isx2 + a2 * isy2)
    cxy = -(ax * ay * (isx2 - isy2))
    c_px = -(2.0 * cxx * mlx + cxy * mly)
    c_py = -(2.0 * cyy * mly + cxy * mlx)
    c_1 = (cxx * mlx * mlx + cxy * mlx * mly + cyy * mly * mly
           + torch.log(torch.clamp(pa, min=1e-30)))
    a_raw = torch.exp(cxx * (pxl * pxl) + cxy * (pxl * pyl)
                      + cyy * (pyl * pyl) + c_px * pxl + c_py * pyl + c_1)
  return torch.where(a_raw > config.alpha_threshold,
                     torch.clamp(a_raw, max=config.clamp_max_alpha), 0.0)


def stream_forward_reference(mapping: StreamMapping,
                             config: RasterConfig) -> torch.Tensor:
  """Plain-torch twin of the stream forward kernel, vectorised over
  chunks of tiles: gather each (tile, slab)'s window rows, order them by
  the rank key ``depth << 11 | slot``, alpha at every pixel, exclusive
  ``cumsum`` of ``log1p(-alpha)`` plus the carry, then the freeze."""
  dev = mapping.table.device
  f = mapping.feature_size
  rpb = mapping.rows_per_block
  table = mapping.table.reshape(-1, mapping.table.shape[1] // rpb)
  dtype = table.dtype
  t_all, s_all = mapping.num_tiles, mapping.num_slabs
  ts = config.tile_size
  pix = config.tile_area
  tw = mapping.tiles_wide
  lcut = _log_cut(config)
  thr = config.saturate_threshold
  blending = config.use_alpha_blending

  slot0, lnc, row0 = _window_slots(mapping)
  used = mapping.desc.view(t_all, s_all, mapping.w_max, 4)[:, :, 0, 1] > 0
  p = torch.arange(pix, device=dev)
  pxl = ((p % ts).to(dtype) + 0.5 - ts * 0.5)
  pyl = ((p // ts).to(dtype) + 0.5 - ts * 0.5)
  tiles = torch.arange(t_all, device=dev)
  ox_all = ((tiles % tw) * ts).to(dtype) + ts * 0.5
  oy_all = ((tiles // tw) * ts).to(dtype) + ts * 0.5
  out = torch.zeros((t_all, f + 1, pix), dtype=dtype, device=dev)

  chunk = max(1, (1 << 23) // (mapping.slab_cap * pix))
  for t0 in range(0, t_all, chunk):
    sl = slice(t0, min(t0 + chunk, t_all))
    n_c = sl.stop - sl.start
    ox, oy = ox_all[sl, None], oy_all[sl, None]
    carry = torch.zeros((n_c, pix), dtype=dtype, device=dev)
    img = out[sl]
    for s in range(s_all):
      s0, ln, r0 = slot0[sl, s], lnc[sl, s], row0[sl, s]     # (C, W)
      width = int((s0 + ln).max()) if ln.numel() else 0
      if s == 0:
        active = torch.ones(n_c, dtype=torch.bool, device=dev)
      else:
        active = used[sl, s] & ~(carry.max(-1).values <= lcut)
      if width == 0 or not bool(active.any()):
        if not blending:   # an empty slab leaves lt_end = the carry
          img[:, f] = torch.where(active[:, None],
                                  (carry < 0.0).to(dtype), img[:, f])
        continue
      slots = torch.arange(width, device=dev)
      row_idx = torch.full((n_c, width), -1, dtype=torch.int64, device=dev)
      for k in range(s0.shape[1]):
        rel = slots - s0[:, k, None]
        inside = (rel >= 0) & (rel < ln[:, k, None])
        row_idx = torch.where(inside, r0[:, k, None] + rel, row_idx)
      valid = row_idx >= 0
      rows = table[torch.clamp(row_idx, min=0)]               # (C, L, Wp)
      rank = torch.where(
          valid, (rows[..., 7 + f].to(torch.int64) << 11) | slots,
          torch.iinfo(torch.int64).max)
      order = torch.argsort(rank, -1)
      n_keep = max(1, int(valid.sum(-1).max()))
      order = order[:, :n_keep]
      valid = torch.gather(valid, 1, order)
      rows = torch.gather(rows, 1, order[..., None].expand(
          -1, -1, rows.shape[-1]))
      a = _alpha(rows, ox, oy, pxl, pyl, config)              # (C, L, PIX)
      a = torch.where(valid[..., None], a, 0.0)
      l = torch.log1p(-a)
      csum = torch.cumsum(l, 1)
      lt_in = carry[:, None, :]
      lt = torch.cat([torch.zeros_like(csum[:, :1]), csum[:, :-1]], 1) + lt_in
      lt_end = carry + csum[:, -1]
      feats = rows[..., 7:7 + f]                              # (C, L, F)
      if blending:
        w = torch.where(lt > lcut, a * torch.exp(lt), 0.0)
        contrib = torch.cat([torch.einsum("clf,clp->cfp", feats, w),
                             w.sum(1)[:, None, :]], 1)
        new_carry = torch.maximum(
            lt_end, torch.where(lt <= lcut, lt, _NEG_BIG).max(1).values)
        img += torch.where(active[:, None, None], contrib, 0.0)
      else:
        t = torch.exp(lt)
        sel = ((t * (1.0 - a) <= thr) & (t > thr)).to(dtype)
        contrib = torch.einsum("clf,clp->cfp", feats, sel)
        img[:, :f] += torch.where(active[:, None, None], contrib, 0.0)
        img[:, f] = torch.where(active[:, None], (lt_end < 0.0).to(dtype),
                                img[:, f])
        new_carry = lt_end
      carry = torch.where(active[:, None], new_carry, carry)
  return out


def _check_kernel_inputs(mapping: StreamMapping, config: RasterConfig):
  table, desc, sb = mapping.table, mapping.desc, mapping.strip_blk
  dev = table.device
  for name, x, dt in (("table", table, torch.float32),
                      ("desc", desc, torch.int32),
                      ("strip_blk", sb, torch.int32)):
    if x.device != dev:
      raise ValueError(f"stream_forward: {name} on {x.device}, table on {dev}")
    if x.dtype != dt:
      raise TypeError(f"stream_forward: {name} must be {dt}, got {x.dtype}")
    if not x.is_contiguous():
      raise ValueError(f"stream_forward: {name} must be contiguous")
  w_pad = table.shape[1] // mapping.rows_per_block
  f = mapping.feature_size
  t, s, w = mapping.num_tiles, mapping.num_slabs, mapping.w_max
  if f > w_pad - 8 or f > 56:
    raise ValueError(f"stream_forward kernel: {f} features exceed the row "
                     f"stride {w_pad} (at most {min(w_pad - 8, 56)})")
  if tuple(desc.shape) != (mapping.num_groups, 1,
                           mapping.group_width * s * w * 4):
    raise ValueError(f"stream_forward: desc shape {tuple(desc.shape)}")
  if tuple(sb.shape) != (mapping.num_groups, 3):
    raise ValueError(f"stream_forward: strip_blk shape {tuple(sb.shape)}")
  if mapping.num_groups * mapping.group_width != t:
    raise ValueError("stream_forward: groups do not cover the tiles")
  if mapping.slab_cap > 2048:
    raise ValueError(f"slab_cap {mapping.slab_cap} overflows the 11-bit "
                     "rank-key slot")
  if config.tile_area > 1024:
    raise ValueError(f"tile_size {config.tile_size}: one thread per pixel "
                     "allows at most 1024 pixels per tile")
  return w_pad


_SMEM_LIMIT = 232448   # dynamic shared memory per block on Hopper


@functools.cache
def _kernel():
  """The built library, with its C signatures declared (once)."""
  from ..utils.cuda_build import load_kernel_library
  lib = load_kernel_library("stream_forward.cu")
  lib.tpu_splat_stream_forward.restype = ctypes.c_int
  lib.tpu_splat_stream_forward.argtypes = (
      [ctypes.c_void_p] * 4 + [ctypes.c_int] * 13 + [ctypes.c_float] * 4
      + [ctypes.c_void_p])
  lib.tpu_splat_stream_forward_smem.restype = ctypes.c_longlong
  lib.tpu_splat_stream_forward_smem.argtypes = [ctypes.c_int] * 3
  return lib


def stream_forward(mapping: StreamMapping,
                   config: RasterConfig) -> torch.Tensor:
  """Forward rasterization over a stream mapping: (T, F+1, PIX).

  CPU mapping -> ``stream_forward_reference``; CUDA mapping -> the
  ``csrc/stream_forward.cu`` kernel, or an exception."""
  dev = mapping.table.device
  if dev.type == "cpu":
    return stream_forward_reference(mapping, config)
  if dev.type != "cuda":
    raise ValueError(f"stream_forward: unsupported device {dev}")
  w_pad = _check_kernel_inputs(mapping, config)
  lib = _kernel()
  f = mapping.feature_size
  smem = lib.tpu_splat_stream_forward_smem(mapping.slab_cap, mapping.w_max, f)
  if smem > _SMEM_LIMIT:
    raise ValueError(f"stream_forward kernel needs {smem} B of shared memory "
                     f"(slab_cap {mapping.slab_cap}, {f} features); the "
                     f"limit is {_SMEM_LIMIT}")
  out = torch.empty((mapping.num_tiles, f + 1, config.tile_area),
                    dtype=torch.float32, device=dev)
  with torch.cuda.device(dev):
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.tpu_splat_stream_forward(
        mapping.table.data_ptr(), mapping.desc.data_ptr(),
        mapping.strip_blk.data_ptr(), out.data_ptr(),
        mapping.num_tiles, mapping.tiles_wide, mapping.group_width,
        mapping.num_slabs, mapping.w_max, mapping.strip_cap,
        mapping.slab_cap, mapping.rows_per_block, w_pad, f,
        config.tile_size, int(config.antialias),
        int(config.use_alpha_blending), config.alpha_threshold,
        config.clamp_max_alpha, _log_cut(config),
        config.saturate_threshold, stream)
  if err != 0:
    raise RuntimeError(f"stream_forward kernel launch failed: CUDA error "
                       f"{err}")
  launch_counts["stream_forward"] += 1
  return out
