"""Stream rasterization kernels and their plain twins.

Counterpart of ``tpu_splatting/rasterizer/stream_kernels.py``.

* ``stream_forward`` (K1) takes a ``StreamMapping`` and returns the
  (T, F+1, tile_area) tiled image; channel F is the alpha (weight) image
  in blending mode and the hit mask in quantile mode.
* ``stream_backward`` (K2, with the reference's slab merge K3 fused in)
  takes the mapping, the forward image and its cotangent and returns the
  home-major gradient buffer (T * run_cap + 1, slabw): row
  ``home * run_cap + r`` holds the summed gradient of the r-th row of
  that home's run, and the last row stays zero (the sentinel row that
  ``grad_src`` / ``dup_src`` point at).  This is the output boundary of
  the reference's ``merge_grad_slabs(stream_backward(...))``, as one
  (R + 1, slabw) matrix instead of slabw (R,) columns.
* Band sharding (``parallel/stream_sharded.py``): both take ``band0``,
  the absolute tile band of a shard's first band, and ``stream_backward``
  with ``halo=True`` adds into a buffer of ``tiles_high + 2`` bands of
  homes (a halo band above and below the shard's own).  ``halo_merge``
  (the reference's ``merge_grad_slabs(..., halo=True)``, K3's halo mode)
  adds the halo bands received from the neighbouring shards into a
  shard's first and last own bands.

A mapping on a CUDA device goes to the hand-written Hopper kernels in
``csrc/`` (built at first use); each wrapper checks shapes and types,
picks the kernel's instantiation and block (``stream_forward_plan``,
``stream_backward_plan``: any feature count and tile size up to 32, a
ValueError with the bytes only where one block's shared memory cannot
hold the shapes), launches on the current stream, raises on a launch
error and counts the launch in ``launch_counts``.  A mapping on the CPU
goes to the ``*_reference`` twin, the same function in plain torch.
There is no fallback between the two.

Both passes compute alpha with the forward's formula (``_alpha_raw``:
the quadratic form with log(point alpha) folded in), so the forward and
the backward make the same threshold, clamp and freeze decisions (ROADMAP
F1).  The reference's ``ablate`` and ``with_counts`` instruments and
``with_asm`` / ``stream_share_asm`` (TPU-only residuals) are not
ported.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..data_types import RasterConfig
from ..utils.cuda_build import (KernelPlan, acc_stride, block_threads,
                                 check_smem, declare_plan_entries,
                                 instantiation, launch_stream,
                                 load_kernel_library)
from .kernels import _NEG_BIG, _antialias_grads, _s_sig, quad_coeffs
from .stream import STRIP_SLACK, StreamMapping

# kernel launches per wrapper; only the wrapper's launch site adds to it
launch_counts = {"stream_forward": 0, "stream_backward": 0, "halo_merge": 0}
# launches of the floor probe, which lies on no path of the system
probe_launch_counts = {"stream_forward_floor": 0}


def reset_launch_counts():
  for counts in (launch_counts, probe_launch_counts):
    for k in counts:
      counts[k] = 0


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


def window_grad_rows(mapping: StreamMapping,
                     halo: bool = False) -> torch.Tensor:
  """(T, S, W) home-major gradient-buffer row of each window's first row
  (``halo``: in a buffer whose home bands start one band above the
  mapping's, ``stream_backward(..., halo=True)``'s).

  A window of tile i (position i in its group) and class b*3+k reads the
  run of home (band y+b-1, column x+k-1), and its descriptor's gbuf_dst
  is the row's offset in that run plus (i+k) * run_cap (the reference's
  per-group slab position, ``_merge_kernel``).  So table row ``row0 + r``
  of the window lands at ``home * run_cap + gbuf_dst - (i+k) * run_cap
  + r`` — the row ``grad_src`` gives its point.  Empty windows hold
  garbage."""
  t, s, w = mapping.num_tiles, mapping.num_slabs, mapping.w_max
  desc = mapping.desc.view(t, s, w, 4).to(torch.int64)
  dst, b, k = desc[..., 2], desc[..., 3] // 3, desc[..., 3] % 3
  tiles = torch.arange(t, device=desc.device)[:, None, None]
  tw, rc = mapping.tiles_wide, mapping.run_cap
  home = (tiles // tw + b - 1 + int(halo)) * tw + tiles % tw + k - 1
  return (home - tiles % mapping.group_width - k) * rc + dst


def _staged_lengths(mapping: StreamMapping) -> torch.Tensor:
  """(T, S, W) rows of each window that K1 stages: ``_window_slots``'s
  lengths in slab 0 and in every slab whose window 0 is not empty (K1
  skips an empty plan slot)."""
  t, s, w = mapping.num_tiles, mapping.num_slabs, mapping.w_max
  staged = mapping.desc.view(t, s, w, 4)[:, :, 0, 1] > 0
  staged[:, 0] = True
  return _window_slots(mapping)[1] * staged[..., None]


def _alpha_raw(rows, ox, oy, pxl, pyl, config: RasterConfig):
  """(C, L, PIX) raw alpha of rows (C, L, >=7) at the tile-centred pixel
  coordinates, the reference forward's formulas; in antialias mode also
  (tu, tv), the unscaled rotated-frame coordinates."""
  mlx = (rows[..., 0] - ox)[..., None]
  mly = (rows[..., 1] - oy)[..., None]
  ax, ay = rows[..., 2, None], rows[..., 3, None]
  sx, sy, pa = rows[..., 4, None], rows[..., 5, None], rows[..., 6, None]
  if config.antialias:
    tu = ax * pxl + ay * pyl + (-(mlx * ax + mly * ay))
    tv = -ay * pxl + ax * pyl + (mlx * ay - mly * ax)
    sxc = torch.clamp(sx, min=1e-12)
    syc = torch.clamp(sy, min=1e-12)
    ix = sxc * (_s_sig(tu + 0.5, sxc) - _s_sig(tu - 0.5, sxc))
    iy = syc * (_s_sig(tv + 0.5, syc) - _s_sig(tv - 0.5, syc))
    return pa * (2.0 * math.pi * ix * iy), (tu, tv)
  else:
    cxx, cxy, cyy, c_px, c_py, c_1 = quad_coeffs(mlx, mly, ax, ay, sx, sy,
                                                 pa)
    a_raw = torch.exp(cxx * (pxl * pxl) + cxy * (pxl * pyl)
                      + cyy * (pyl * pyl) + c_px * pxl + c_py * pyl + c_1)
    return a_raw, None


def _threshold(a_raw, config: RasterConfig):
  return torch.where(a_raw > config.alpha_threshold,
                     torch.clamp(a_raw, max=config.clamp_max_alpha), 0.0)


def _slab_rows(table, s0, ln, r0, width: int, f: int, g0=None):
  """One slab's window rows of a chunk of tiles, in rank-key order.

  s0, ln, r0 (C, W): window slots, lengths and first table rows.  Returns
  (valid (C, L), rows (C, L, W_PAD), grad_rows (C, L) or None): the rows
  sorted by ``depth << 11 | slot`` (invalid slots last) and, when g0
  (C, W) gives each window's first gradient-buffer row, each row's."""
  dev = table.device
  n_c = s0.shape[0]
  slots = torch.arange(width, device=dev)
  row_idx = torch.full((n_c, width), -1, dtype=torch.int64, device=dev)
  grad_idx = None if g0 is None else torch.full_like(row_idx, -1)
  for k in range(s0.shape[1]):
    rel = slots - s0[:, k, None]
    inside = (rel >= 0) & (rel < ln[:, k, None])
    row_idx = torch.where(inside, r0[:, k, None] + rel, row_idx)
    if g0 is not None:
      grad_idx = torch.where(inside, g0[:, k, None] + rel, grad_idx)
  valid = row_idx >= 0
  rows = table[torch.clamp(row_idx, min=0)]                   # (C, L, Wp)
  rank = torch.where(
      valid, (rows[..., 7 + f].to(torch.int64) << 11) | slots,
      torch.iinfo(torch.int64).max)
  order = torch.argsort(rank, -1)
  n_keep = max(1, int(valid.sum(-1).max()))
  order = order[:, :n_keep]
  valid = torch.gather(valid, 1, order)
  rows = torch.gather(rows, 1, order[..., None].expand(-1, -1, rows.shape[-1]))
  if grad_idx is not None:
    grad_idx = torch.gather(grad_idx, 1, order)
  return valid, rows, grad_idx


def stream_forward_reference(mapping: StreamMapping, config: RasterConfig,
                             band0: int = 0) -> torch.Tensor:
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
  oy_all = ((band0 + tiles // tw) * ts).to(dtype) + ts * 0.5
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
      valid, rows, _ = _slab_rows(table, s0, ln, r0, width, f)
      a = _threshold(_alpha_raw(rows, ox, oy, pxl, pyl, config)[0], config)
      a = torch.where(valid[..., None], a, 0.0)               # (C, L, PIX)
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


def _row_grads(rows, ox, oy, pxl, pyl, a_raw, aux, ag, z0, config):
  """(C, L, PIX) per-pixel terms of the 7 packed-gaussian gradients (the
  pa column before its 1 / pa) and of the split score."""
  mlx = (rows[..., 0] - ox)[..., None]
  mly = (rows[..., 1] - oy)[..., None]
  ax, ay = rows[..., 2, None], rows[..., 3, None]
  sx, sy, pa = rows[..., 4, None], rows[..., 5, None], rows[..., 6, None]
  dx, dy = pxl - mlx, pyl - mly
  if config.antialias:
    tu, tv = aux
    clamp_live = (a_raw < config.clamp_max_alpha).to(ag.dtype)
    aag = pa * ag * clamp_live
    g6 = [aag * d for d in _antialias_grads(tu, tv, sx, sy, dx, dy, ax, ay)]
  else:
    # through the sigma-scaled rotated coordinates u, v (reference
    # _bwd_kernel :871-893, per pixel instead of through pixel moments)
    isx = 1.0 / torch.clamp(sx, min=1e-12)
    isy = 1.0 / torch.clamp(sy, min=1e-12)
    u = (ax * dx + ay * dy) * isx
    v = (-ay * dx + ax * dy) * isy
    zu, zv = z0 * u, z0 * v
    g6 = [ax * isx * zu - ay * isy * zv,
          ay * isx * zu + ax * isy * zv,
          -isx * zu * dx - isy * zv * dy,
          -isx * zu * dy + isy * zv * dx,
          isx * zu * u,
          isy * zv * v]
  return g6 + [z0], torch.abs(g6[0]) + torch.abs(g6[1])


def stream_backward_reference(mapping: StreamMapping,
                              image_tiled: torch.Tensor,
                              g_image_tiled: torch.Tensor,
                              config: RasterConfig, band0: int = 0,
                              halo: bool = False) -> torch.Tensor:
  """Plain-torch twin of the stream backward kernel: (T*run_cap + 1,
  slabw) home-major gradient buffer ((T + 2*tiles_wide)*run_cap + 1 rows
  with ``halo``).

  Per chunk of tiles and per slab it recomputes the forward (the same
  gathers, rank order, alpha, log transmittance and freeze as
  ``stream_forward_reference``), forms every (row, pixel)'s gradient
  terms, sums them over the pixels and ``index_add_``s each row into its
  home-major buffer row.  Two carries cross slabs, as in the reference
  ``_bwd_kernel``: the frozen log transmittance and the running sum of
  w * (features . g_image)."""
  if not config.use_alpha_blending:
    raise ValueError("stream backward: quantile mode has no backward")
  dev = mapping.table.device
  f = mapping.feature_size
  rpb = mapping.rows_per_block
  table = mapping.table.reshape(-1, mapping.table.shape[1] // rpb)
  dtype = table.dtype
  t_all, s_all = mapping.num_tiles, mapping.num_slabs
  ts, pix, tw = config.tile_size, config.tile_area, mapping.tiles_wide
  lcut = _log_cut(config)
  cmax = config.clamp_max_alpha
  heur = config.compute_point_heuristic
  with_vis = heur or config.compute_visibility
  slabw = slab_width(config, f)
  r_rows = (t_all + (2 * tw if halo else 0)) * mapping.run_cap

  slot0, lnc, row0 = _window_slots(mapping)
  grow0 = window_grad_rows(mapping, halo)
  used = mapping.desc.view(t_all, s_all, mapping.w_max, 4)[:, :, 0, 1] > 0
  p = torch.arange(pix, device=dev)
  pxl = ((p % ts).to(dtype) + 0.5 - ts * 0.5)
  pyl = ((p // ts).to(dtype) + 0.5 - ts * 0.5)
  tiles = torch.arange(t_all, device=dev)
  ox_all = ((tiles % tw) * ts).to(dtype) + ts * 0.5
  oy_all = ((band0 + tiles // tw) * ts).to(dtype) + ts * 0.5
  img = image_tiled.to(dtype)
  gimg = g_image_tiled.to(dtype)
  s_total_all = (gimg * img).sum(1)                           # (T, PIX)
  buf = torch.zeros((r_rows + 1, slabw), dtype=dtype, device=dev)

  chunk = max(1, (1 << 22) // (mapping.slab_cap * pix))
  for t0 in range(0, t_all, chunk):
    sl = slice(t0, min(t0 + chunk, t_all))
    n_c = sl.stop - sl.start
    ox, oy = ox_all[sl, None], oy_all[sl, None]
    gi, s_total = gimg[sl], s_total_all[sl]
    carry = torch.zeros((n_c, pix), dtype=dtype, device=dev)
    s_prev = torch.zeros((n_c, pix), dtype=dtype, device=dev)
    for s in range(s_all):
      s0, ln = slot0[sl, s], lnc[sl, s]
      width = int((s0 + ln).max()) if ln.numel() else 0
      if s == 0:
        active = torch.ones(n_c, dtype=torch.bool, device=dev)
      else:
        active = used[sl, s] & ~(carry.max(-1).values <= lcut)
      if width == 0 or not bool(active.any()):
        continue
      valid, rows, grow = _slab_rows(table, s0, ln, row0[sl, s], width, f,
                                     grow0[sl, s])
      a_raw, aux = _alpha_raw(rows, ox, oy, pxl, pyl, config)
      a = torch.where(valid[..., None], _threshold(a_raw, config), 0.0)
      l = torch.log1p(-a)
      csum = torch.cumsum(l, 1)
      lt = (torch.cat([torch.zeros_like(csum[:, :1]), csum[:, :-1]], 1)
            + carry[:, None, :])
      live = (lt > lcut) & (a > 0.0)
      t = torch.exp(lt)
      w = torch.where(live, a * t, 0.0)
      feats = rows[..., 7:7 + f]                              # (C, L, F)
      gf = torch.einsum("clf,cfp->clp", feats, gi[:, :f]) + gi[:, None, f]
      wgf = w * gf
      s_i = s_total[:, None] - (torch.cumsum(wgf, 1) + s_prev[:, None])
      ag = torch.where(live, t * gf - s_i / (1.0 - a), 0.0)
      z0 = torch.where(live & (a_raw < cmax), ag * a_raw, 0.0)
      g7, split = _row_grads(rows, ox, oy, pxl, pyl, a_raw, aux, ag, z0,
                             config)
      pa = rows[..., 6]
      cols = [g.sum(-1) for g in g7]
      cols[6] = cols[6] / torch.clamp(pa, min=1e-20)
      cols = [torch.stack(cols, -1),
              torch.einsum("clp,cfp->clf", w, gi[:, :f])]
      if with_vis:
        cols.append(w.sum(-1)[..., None])
      if heur:
        cols.append(torch.stack([(ag * ag).sum(-1) * (pa * pa),
                                 split.sum(-1)], -1))
      vals = torch.cat(cols, -1)                              # (C, L, slabw)
      keep = valid & active[:, None] & (grow >= 0) & (grow < r_rows)
      buf.index_add_(0, grow[keep], vals[keep])

      lt_end = carry + csum[:, -1]
      new_carry = torch.maximum(
          lt_end, torch.where(lt <= lcut, lt, _NEG_BIG).max(1).values)
      carry = torch.where(active[:, None], new_carry, carry)
      s_prev = torch.where(active[:, None], s_prev + wgf.sum(1), s_prev)
  return buf


def _check_kernel_inputs(mapping: StreamMapping, config: RasterConfig,
                         name: str = "stream_forward"):
  table, desc, sb = mapping.table, mapping.desc, mapping.strip_blk
  dev = table.device
  for field, x, dt in (("table", table, torch.float32),
                       ("desc", desc, torch.int32),
                       ("strip_blk", sb, torch.int32)):
    if x.device != dev:
      raise ValueError(f"{name}: {field} on {x.device}, table on {dev}")
    if x.dtype != dt:
      raise TypeError(f"{name}: {field} must be {dt}, got {x.dtype}")
    if not x.is_contiguous():
      raise ValueError(f"{name}: {field} must be contiguous")
  w_pad = table.shape[1] // mapping.rows_per_block
  f = mapping.feature_size
  t, s, w = mapping.num_tiles, mapping.num_slabs, mapping.w_max
  if f > w_pad - 8:
    raise ValueError(f"{name} kernel: {f} features exceed the row "
                     f"stride {w_pad} (at most {w_pad - 8})")
  if tuple(desc.shape) != (mapping.num_groups, 1,
                           mapping.group_width * s * w * 4):
    raise ValueError(f"{name}: desc shape {tuple(desc.shape)}")
  if tuple(sb.shape) != (mapping.num_groups, 3):
    raise ValueError(f"{name}: strip_blk shape {tuple(sb.shape)}")
  if mapping.num_groups * mapping.group_width != t:
    raise ValueError(f"{name}: groups do not cover the tiles")
  if mapping.slab_cap > 2048:
    raise ValueError(f"slab_cap {mapping.slab_cap} overflows the 11-bit "
                     "rank-key slot")
  if config.tile_area > 1024:
    raise ValueError(f"tile_size {config.tile_size}: one thread per pixel "
                     "allows at most 1024 pixels per tile")
  return w_pad


# register instantiations (most features) of csrc/stream_forward.cu and
# csrc/stream_backward.cu; more features take the generic one
K1_WIDTHS = (4, 8, 24, 56)
K2_WIDTHS = (6, 22, 56)
# the register instantiation that has a floor probe (the headline's)
FLOOR_WIDTH = 4


def _sort_cap(slab_cap: int) -> int:
  return 1 << max(0, (slab_cap - 1).bit_length())


def stream_forward_plan(f: int, slab_cap: int, w_max: int,
                        tile_area: int) -> KernelPlan:
  """K1's instantiation, threads (the tile's pixels in whole warps) and
  shared memory: per-slot footprints (4 floats), rank keys, per-row
  coefficients and features, window descriptors, generic every thread's
  F accumulators, and one 16-bit row list per warp
  (``tpu_splat_stream_forward_smem``)."""
  threads = block_threads(tile_area)
  mf = instantiation(f, tile_area, K1_WIDTHS)
  smem = (4 * (_sort_cap(slab_cap) + (4 + 7 + f) * slab_cap + 7 * w_max + 2
               + (f * threads if mf == 0 else 0))
          + 2 * (threads // 32) * slab_cap)
  return KernelPlan(mf, threads, smem)


def stream_backward_plan(f: int, slab_cap: int, w_max: int, slabw: int,
                         tile_area: int) -> KernelPlan:
  """K2's instantiation, threads (the tile's pixels in whole warps) and
  shared memory: rank keys, per-row coefficients and features, the
  [column][slot] accumulator, window descriptors and, generic, every
  thread's F image cotangents (``tpu_splat_stream_backward_smem``)."""
  threads = block_threads(tile_area)
  mf = instantiation(f, tile_area, K2_WIDTHS)
  smem = 4 * (_sort_cap(slab_cap) + (12 + f) * slab_cap
              + slabw * acc_stride(slab_cap) + 8 * w_max + 2
              + (f * threads if mf == 0 else 0))
  return KernelPlan(mf, threads, smem)


@functools.cache
def _kernel():
  """The built library, with its C signatures declared (once)."""
  lib = load_kernel_library("stream_forward.cu")
  lib.tpu_splat_stream_forward.restype = ctypes.c_int
  lib.tpu_splat_stream_forward.argtypes = (
      [ctypes.c_void_p] * 4 + [ctypes.c_int] * 17 + [ctypes.c_float] * 4
      + [ctypes.c_void_p])
  declare_plan_entries(lib, "tpu_splat_stream_forward", 5)
  return lib


def stream_forward(mapping: StreamMapping, config: RasterConfig,
                   band0: int = 0) -> torch.Tensor:
  """Forward rasterization over a stream mapping: (T, F+1, PIX).
  ``band0``: the absolute tile band of the mapping's first band (a shard
  of a band-sharded image; 0 otherwise).

  CPU mapping -> ``stream_forward_reference``; CUDA mapping -> the
  ``csrc/stream_forward.cu`` kernel, or an exception."""
  if mapping.table.device.type == "cpu":
    return stream_forward_reference(mapping, config, band0)
  out = _launch_forward(mapping, config, True, "stream_forward", band0)
  launch_counts["stream_forward"] += 1
  return out


def stream_forward_floor_reference(mapping: StreamMapping,
                                   config: RasterConfig) -> torch.Tensor:
  """Plain twin of ``stream_forward_floor``: a zero (T, F+1, PIX) image
  whose channel 0 holds the number of window rows each tile staged."""
  out = mapping.table.new_zeros((mapping.num_tiles, mapping.feature_size + 1,
                                 config.tile_area))
  out[:, 0] = _staged_lengths(mapping).sum((1, 2)).to(out.dtype)[:, None]
  return out


def stream_forward_floor(mapping: StreamMapping,
                         config: RasterConfig) -> torch.Tensor:
  """K1's floor probe: K1's grid, slab loop, window assembly, row
  fetch, staging, rank sort and output write with the walk taken out
  (blending mode, the ``<FLOOR_WIDTH>`` instantiation).  A measuring
  instrument on no path of the system, the stream pipeline's counterpart
  of ``kernels.forward_floor``.

  CPU mapping -> ``stream_forward_floor_reference``; CUDA mapping -> the
  kernel, or an exception."""
  if mapping.table.device.type == "cpu":
    return stream_forward_floor_reference(mapping, config)
  if not config.use_alpha_blending:
    raise ValueError("stream_forward floor: blending mode only")
  out = _launch_forward(mapping, config, False, "stream_forward floor")
  probe_launch_counts["stream_forward_floor"] += 1
  return out


def _launch_forward(mapping: StreamMapping, config: RasterConfig,
                    walk: bool, name: str, band0: int = 0) -> torch.Tensor:
  """Check, plan and launch ``csrc/stream_forward.cu``: the compositing
  kernel, or (``walk`` False) its floor probe."""
  dev = mapping.table.device
  if dev.type != "cuda":
    raise ValueError(f"{name}: unsupported device {dev}")
  w_pad = _check_kernel_inputs(mapping, config)
  f = mapping.feature_size
  plan = stream_forward_plan(f, mapping.slab_cap, mapping.w_max,
                             config.tile_area)
  check_smem(name, plan, f"slab_cap {mapping.slab_cap}, w_max "
             f"{mapping.w_max}, {f} features, {config.tile_area} pixels")
  if not walk and plan.max_features != FLOOR_WIDTH:
    raise ValueError(f"{name}: the floor probe is built for the "
                     f"<{FLOOR_WIDTH}> instantiation only ({f} features, "
                     f"{config.tile_area} pixels)")
  lib = _kernel()
  out = torch.empty((mapping.num_tiles, f + 1, config.tile_area),
                    dtype=torch.float32, device=dev)
  with launch_stream(dev) as stream:
    err = lib.tpu_splat_stream_forward(
        mapping.table.data_ptr(), mapping.desc.data_ptr(),
        mapping.strip_blk.data_ptr(), out.data_ptr(),
        mapping.num_tiles, mapping.tiles_wide, mapping.group_width,
        mapping.num_slabs, mapping.w_max, mapping.strip_cap,
        mapping.slab_cap, mapping.rows_per_block, w_pad, f,
        config.tile_size, int(config.antialias),
        int(config.use_alpha_blending), plan.max_features, plan.threads,
        int(walk), band0, config.alpha_threshold,
        config.clamp_max_alpha, _log_cut(config), config.saturate_threshold,
        stream)
  if err != 0:
    raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
  return out


@functools.cache
def _bwd_kernel():
  lib = load_kernel_library("stream_backward.cu")
  lib.tpu_splat_stream_backward.restype = ctypes.c_int
  lib.tpu_splat_stream_backward.argtypes = (
      [ctypes.c_void_p] * 6 + [ctypes.c_int] * 20 + [ctypes.c_float] * 3
      + [ctypes.c_void_p])
  declare_plan_entries(lib, "tpu_splat_stream_backward", 6)
  lib.tpu_splat_halo_merge.restype = ctypes.c_int
  lib.tpu_splat_halo_merge.argtypes = (
      [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                               ctypes.c_void_p])
  lib.tpu_splat_halo_merge_occupancy.restype = ctypes.c_int
  lib.tpu_splat_halo_merge_occupancy.argtypes = [
      ctypes.POINTER(ctypes.c_int)]
  return lib


def stream_backward(mapping: StreamMapping, image_tiled: torch.Tensor,
                    g_image_tiled: torch.Tensor, config: RasterConfig,
                    band0: int = 0, halo: bool = False) -> torch.Tensor:
  """Backward rasterization: the (T*run_cap + 1, slabw) home-major
  gradient buffer of ``stream_forward``'s image cotangent.  ``band0`` as
  in ``stream_forward``; with ``halo`` the buffer holds tiles_high + 2
  bands of homes, ((T + 2*tiles_wide)*run_cap + 1, slabw): a halo band
  above the mapping's bands, its own, and a halo band below.  A shard
  (``band0`` > 0) needs the halo: rows homed outside its own bands belong
  to its neighbours.

  CPU mapping -> ``stream_backward_reference``; CUDA mapping -> the
  ``csrc/stream_backward.cu`` kernel, or an exception."""
  if band0 != 0 and not halo:
    raise ValueError("stream_backward: band0 > 0 without halo would drop "
                     "the rows homed in the neighbouring shards")
  dev = mapping.table.device
  if dev.type == "cpu":
    return stream_backward_reference(mapping, image_tiled, g_image_tiled,
                                     config, band0, halo)
  if dev.type != "cuda":
    raise ValueError(f"stream_backward: unsupported device {dev}")
  if not config.use_alpha_blending:
    raise ValueError("stream backward: quantile mode has no backward")
  w_pad = _check_kernel_inputs(mapping, config, "stream_backward")
  f = mapping.feature_size
  t, pix = mapping.num_tiles, config.tile_area
  for name, x in (("image_tiled", image_tiled),
                  ("g_image_tiled", g_image_tiled)):
    if x.device != dev:
      raise ValueError(f"stream_backward: {name} on {x.device}, table on "
                       f"{dev}")
    if x.dtype != torch.float32:
      raise TypeError(f"stream_backward: {name} must be torch.float32, got "
                      f"{x.dtype}")
    if tuple(x.shape) != (t, f + 1, pix):
      raise ValueError(f"stream_backward: {name} shape {tuple(x.shape)}, "
                       f"expected {(t, f + 1, pix)}")
  image_tiled = image_tiled.contiguous()
  g_image_tiled = g_image_tiled.contiguous()
  slabw = slab_width(config, f)
  heur = config.compute_point_heuristic
  with_vis = heur or config.compute_visibility
  plan = stream_backward_plan(f, mapping.slab_cap, mapping.w_max, slabw, pix)
  check_smem("stream_backward", plan, f"slab_cap {mapping.slab_cap}, w_max "
             f"{mapping.w_max}, {f} features, {slabw} gradient columns, "
             f"{pix} pixels")
  homes = t + (2 * mapping.tiles_wide if halo else 0)
  if homes * mapping.run_cap >= (1 << 31):
    # the kernel's gradient-row numbers (r_rows, grow) are 32-bit ints
    raise ValueError(f"stream_backward: {homes} homes x run_cap "
                     f"{mapping.run_cap} = {homes * mapping.run_cap} "
                     f"gradient rows pass the kernel's 32-bit row index")
  lib = _bwd_kernel()
  out = torch.zeros((homes * mapping.run_cap + 1, slabw),
                    dtype=torch.float32, device=dev)
  with launch_stream(dev) as stream:
    err = lib.tpu_splat_stream_backward(
        mapping.table.data_ptr(), mapping.desc.data_ptr(),
        mapping.strip_blk.data_ptr(), image_tiled.data_ptr(),
        g_image_tiled.data_ptr(), out.data_ptr(),
        t, mapping.tiles_wide, mapping.group_width, mapping.num_slabs,
        mapping.w_max, mapping.strip_cap, mapping.slab_cap,
        mapping.rows_per_block, w_pad, f, config.tile_size,
        int(config.antialias), mapping.run_cap, slabw, int(with_vis),
        int(heur), plan.max_features, plan.threads, band0, int(halo),
        config.alpha_threshold, config.clamp_max_alpha, _log_cut(config),
        stream)
  if err != 0:
    raise RuntimeError(f"stream_backward kernel launch failed: CUDA error "
                       f"{err}")
  launch_counts["stream_backward"] += 1
  return out


def halo_merge_reference(buf: torch.Tensor, tiles_high: int, band_rows: int,
                         above=None, below=None) -> torch.Tensor:
  """Plain twin of ``halo_merge``: the same adds with torch, in place."""
  own = buf[band_rows:(tiles_high + 1) * band_rows]
  if above is not None:
    own[:band_rows] += above
  if below is not None:
    own[(tiles_high - 1) * band_rows:] += below
  return own


def halo_merge(buf: torch.Tensor, tiles_high: int, band_rows: int,
               above=None, below=None) -> torch.Tensor:
  """K3's halo mode: a shard's merged own bands, in place.

  ``buf`` is the shard's ``stream_backward(..., halo=True)`` buffer of
  ``tiles_high + 2`` bands of ``band_rows`` (tiles_wide * run_cap) rows,
  then the zero row.  ``above`` is the bottom halo band of the shard above
  (rows homed in this shard's first own band by its tiles), ``below`` the
  top halo band of the shard below; either may be None (no peer: the
  reference's ``ppermute`` zeros).  Adds them into the first and the last
  own band (both, above first, where the shard has one band) and returns
  the own bands, rows [band_rows, (tiles_high + 1) * band_rows) of ``buf``.

  CPU buffer -> ``halo_merge_reference``; CUDA buffer -> the
  ``csrc/stream_backward.cu`` halo merge kernel, or an exception."""
  dev = buf.device
  if dev.type == "cpu":
    return halo_merge_reference(buf, tiles_high, band_rows, above, below)
  if dev.type != "cuda":
    raise ValueError(f"halo_merge: unsupported device {dev}")
  if buf.dtype != torch.float32 or not buf.is_contiguous():
    raise TypeError("halo_merge: buf must be a contiguous float32 tensor")
  if buf.dim() != 2 or buf.shape[0] < (tiles_high + 2) * band_rows:
    raise ValueError(f"halo_merge: buf shape {tuple(buf.shape)} holds no "
                     f"{tiles_high} + 2 bands of {band_rows} rows")
  band = (band_rows, buf.shape[1])
  for name, x in (("above", above), ("below", below)):
    if x is None:
      continue
    if x.device != dev or x.dtype != torch.float32 or (
        tuple(x.shape) != band) or not x.is_contiguous():
      raise ValueError(f"halo_merge: {name} must be a contiguous float32 "
                       f"{band} tensor on {dev}, got {tuple(x.shape)} "
                       f"{x.dtype} on {x.device}")
  own = buf[band_rows:(tiles_high + 1) * band_rows]
  if above is None and below is None:
    return own
  lib = _bwd_kernel()
  with launch_stream(dev) as stream:
    err = lib.tpu_splat_halo_merge(
        own.data_ptr(), None if above is None else above.data_ptr(),
        None if below is None else below.data_ptr(),
        band_rows * buf.shape[1], tiles_high, stream)
  if err != 0:
    raise RuntimeError(f"halo_merge kernel launch failed: CUDA error {err}")
  launch_counts["halo_merge"] += 1
  return own
