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
* ``stream_descriptors`` builds the mapping's window descriptors for
  ``stream_map`` (``csrc/stream_map.cu``, one launch for every tile
  group); its twin is ``stream.stream_descriptors_reference``.

A mapping on a CUDA device goes to the hand-written Hopper kernels in
``csrc/`` (built at first use); each wrapper checks shapes and types,
picks the kernel's instantiation and block (``stream_forward_plan``,
``stream_backward_plan``: any feature count and tile size up to 32, a
ValueError with the bytes only where one block's shared memory cannot
hold the shapes), launches on the current stream, raises on a launch
error and counts the launch in ``launch_counts``.  A mapping on the CPU
goes to the ``*_reference`` twin, the same function in plain torch.
There is no fallback between the two.

The forward computes alpha with the quadratic form, log(point alpha)
folded in (``_alpha_raw``).  Without antialias the backward computes it
from the rotated coordinates u, v, as the reference's backward does, and
sums the gradients through pixel moments (``_backward_alpha_raw``,
``_row_sums``, ``_flush_rows``; ROADMAP F16): the two formulas agree to
rounding, so the passes' threshold and freeze decisions can differ only
where a_raw lies within rounding of a cut (F1).

Profiling instruments, the reference's: ``stream_forward(...,
ablate=, with_counts=)`` and ``stream_backward(..., ablate=)`` take one
phase out of the kernel, so that the time saved measures that phase
(``benchmarks/bench_stream.py --profile-fwd / --profile-bwd``), and K1
counts its work per tile group.  Each mode is a kernel of its own, built
for the headline's instantiation only (K1 ``<4>``, K2 ``<6, 16>``), with
a twin of its own formula; they lie on no path of the system and count
their launches in ``probe_launch_counts``.  ``with_asm`` /
``stream_share_asm`` (the TPU's shared assembly, a workaround for its
missing atomics) are not ported.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import trace
from ..data_types import RasterConfig
from ..utils.cuda_build import (KernelPlan, acc_stride, block_threads,
                                 blocks_by_smem, check_smem,
                                 declare_plan_entries, instantiation,
                                 launch_stream, load_kernel_library,
                                 occupancy)
from .kernels import (_NEG_BIG, _antialias_grads, _s_sig, footprint_reference,
                      quad_coeffs, thread_pixels, walk_mask, warp_rects)
from .stream import (STRIP_SLACK, StreamMapping,
                     stream_descriptors_reference)

# The profiling modes (the reference's ``ablate``), numbered as the kernels'
# ``mode``; the forward's skeleton is the floor probe.  ``no_sort`` (no rank
# sort: the walk in fetch-slot order) is the reference's ``no_mask``.
FWD_ABLATIONS = {"": 0, "skeleton": 0, "no_assemble": 1, "no_sort": 2,
                 "no_alpha": 3}
BWD_ABLATIONS = {"": 0, "skeleton": 1, "no_sort": 2, "no_grad": 3,
                 "no_copyback": 4}
ABLATION_ALIASES = {"no_mask": "no_sort"}

# kernel launches per wrapper; only the wrapper's launch site adds to it
# (``stream_backward_chunked``: the K2 launches among ``stream_backward``'s
# whose slabs take more than one chunk)
launch_counts = {"stream_forward": 0, "stream_backward": 0,
                 "stream_backward_chunked": 0, "halo_merge": 0,
                 "stream_descriptors": 0}
# launches of the floor probe and the profiling modes, which lie on no path
# of the system: ``stream_forward_<mode>``, ``stream_forward_counts`` (a
# launch with ``with_counts``, in any mode), ``stream_backward_<mode>``
probe_launch_counts = {
    "stream_forward_floor": 0,
    **{f"stream_forward_{m}": 0 for m in FWD_ABLATIONS if m},
    "stream_forward_counts": 0,
    **{f"stream_backward_{m}": 0 for m in BWD_ABLATIONS if m}}


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


def _used_slabs(mapping: StreamMapping) -> torch.Tensor:
  """(T, S) whether each plan slot holds a slab: its window 0 is not
  empty (the mapper puts nonempty windows first)."""
  t, s, w = mapping.num_tiles, mapping.num_slabs, mapping.w_max
  return mapping.desc.view(t, s, w, 4)[:, :, 0, 1] > 0


def _staged_lengths(mapping: StreamMapping) -> torch.Tensor:
  """(T, S, W) rows of each window that K1 stages: ``_window_slots``'s
  lengths in slab 0 and in every slab whose window 0 is not empty (K1
  skips an empty plan slot)."""
  staged = _used_slabs(mapping)
  staged[:, 0] = True
  return _window_slots(mapping)[1] * staged[..., None]


def _contiguous_slots(mapping: StreamMapping):
  """``_window_slots`` of the profiling mode no_assemble: window 0 holds
  one contiguous range from its first table row, as long as the windows
  together (at most a slab); the other windows are empty."""
  t, s, w = mapping.num_tiles, mapping.num_slabs, mapping.w_max
  desc = mapping.desc.view(t, s, w, 4).to(torch.int64)
  row0 = _window_slots(mapping)[2]
  lnc = torch.zeros_like(row0)
  lnc[..., 0] = torch.clamp(desc[..., 1], min=0).sum(-1).clamp(
      max=mapping.slab_cap)
  return torch.zeros_like(row0), lnc, row0


def _round_out(rects):
  """Footprint rectangles (..., 4) float64 rounded outward to float32, as
  ``quad_footprint`` ends them."""
  inf = math.inf
  f = rects.float()
  down = torch.where(f.double() > rects, torch.nextafter(f, f.new_tensor(-inf)),
                     f)
  up = torch.where(f.double() < rects, torch.nextafter(f, f.new_tensor(inf)),
                   f)
  return torch.stack([down[..., 0], up[..., 1], down[..., 2], up[..., 3]],
                     -1).double()


def _warp_walks(rows, ox, oy, config: RasterConfig, wr):
  """(C, L, W) whether each warp of a K1 block lists each row: its
  footprint (as K1 stages it) meets the warp's pixels; antialias mode
  lists every row."""
  if config.antialias:
    return rows.new_ones(rows.shape[:-1] + (wr.shape[0],), dtype=torch.bool)
  coeffs = quad_coeffs(rows[..., 0] - ox, rows[..., 1] - oy, rows[..., 2],
                       rows[..., 3], rows[..., 4], rows[..., 5], rows[..., 6])
  return walk_mask(_round_out(footprint_reference(
      coeffs, config.alpha_threshold, config.tile_size * 0.5 - 0.5)), wr)


def _ablation(ablate: str, modes: dict, name: str) -> str:
  """The profiling mode ``ablate`` names (``ABLATION_ALIASES`` resolved);
  ValueError for an unknown one."""
  mode = ABLATION_ALIASES.get(ablate, ablate)
  if mode not in modes:
    raise ValueError(f"{name}: unknown ablate {ablate!r}; one of "
                     f"{sorted(modes)} or {sorted(ABLATION_ALIASES)}")
  return mode


def _group_counts(mapping: StreamMapping, per_tile: torch.Tensor):
  """``counts_block`` of (T, 3) counts per tile, summed per tile group."""
  return counts_block(per_tile.view(mapping.num_groups, -1, 3).sum(1))


def counts_block(per_group: torch.Tensor) -> torch.Tensor:
  """The reference's ``with_counts`` block, (G * 8, 128) float32, from
  (G, 3) integer counts per tile group [iterations, rows staged, listed
  (row, warp) pairs]: row g * 8 holds the group's computed (tile, slab)
  iterations in every lane, rows g * 8 + 1 and + 2 the others in lane 0,
  every other entry 0."""
  g = per_group.shape[0]
  out = torch.zeros((g * 8, 128), dtype=torch.float32,
                    device=per_group.device)
  x = per_group.to(torch.float32)
  out[0::8] = x[:, 0, None]
  out[1::8, 0] = x[:, 1]
  out[2::8, 0] = x[:, 2]
  return out


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


def _slab_rows(table, s0, ln, r0, width: int, f: int, g0=None,
               by_slot: bool = False):
  """One slab's window rows of a chunk of tiles, in rank-key order.

  s0, ln, r0 (C, W): window slots, lengths and first table rows (clamped
  to the table).  Returns
  (valid (C, L), rows (C, L, W_PAD), grad_rows (C, L) or None): the rows
  sorted by ``depth << 11 | slot`` (``by_slot``: by slot, the profiling
  mode no_sort; invalid slots last) and, when g0
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
  rows = table[torch.clamp(row_idx, 0, table.shape[0] - 1)]   # (C, L, Wp)
  key = slots if by_slot else (rows[..., 7 + f].to(torch.int64) << 11) | slots
  rank = torch.where(valid, key, torch.iinfo(torch.int64).max)
  order = torch.argsort(rank, -1)
  n_keep = max(1, int(valid.sum(-1).max()))
  order = order[:, :n_keep]
  valid = torch.gather(valid, 1, order)
  rows = torch.gather(rows, 1, order[..., None].expand(-1, -1, rows.shape[-1]))
  if grad_idx is not None:
    grad_idx = torch.gather(grad_idx, 1, order)
  return valid, rows, grad_idx


def stream_forward_reference(mapping: StreamMapping, config: RasterConfig,
                             band0: int = 0, ablate: str = "",
                             with_counts: bool = False):
  """Plain-torch twin of the stream forward kernel, vectorised over
  chunks of tiles: gather each (tile, slab)'s window rows, order them by
  the rank key ``depth << 11 | slot``, alpha at every pixel, exclusive
  ``cumsum`` of ``log1p(-alpha)`` plus the carry, then the freeze.

  ``ablate`` and ``with_counts`` as in ``stream_forward``: no_assemble
  takes ``_contiguous_slots``, no_sort orders by slot, no_alpha takes
  alpha = 1e-6 * the row's first column where the pixel's warp lists the
  row (``_warp_walks``) and 0 elsewhere, skeleton is the floor probe's
  twin; the counts come from the same slabs, rows and walk lists."""
  mode = _ablation(ablate, FWD_ABLATIONS, "stream_forward")
  if mode == "skeleton":
    out = stream_forward_floor_reference(mapping, config)
    if not with_counts:
      return out
    computed = _used_slabs(mapping)       # the floor probe never saturates
    computed[:, 0] = True
    rows = _staged_lengths(mapping).sum((1, 2))
    return out, _group_counts(mapping, torch.stack(
        [computed.sum(1), rows, torch.zeros_like(rows)], -1))
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

  slot0, lnc, row0 = (_contiguous_slots(mapping) if mode == "no_assemble"
                      else _window_slots(mapping))
  used = _used_slabs(mapping)
  p = torch.arange(pix, device=dev)
  pxl = ((p % ts).to(dtype) + 0.5 - ts * 0.5)
  pyl = ((p // ts).to(dtype) + 0.5 - ts * 0.5)
  tiles = torch.arange(t_all, device=dev)
  ox_all = ((tiles % tw) * ts).to(dtype) + ts * 0.5
  oy_all = ((band0 + tiles // tw) * ts).to(dtype) + ts * 0.5
  out = torch.zeros((t_all, f + 1, pix), dtype=dtype, device=dev)
  walks = with_counts or mode == "no_alpha"
  if walks:
    threads = block_threads(pix)
    wr = warp_rects(ts, threads, centred=True)
    tp = thread_pixels(ts, threads)
    warp_of = torch.empty(pix, dtype=torch.int64)
    warp_of[tp[tp >= 0]] = torch.arange(threads)[tp >= 0] // 32
    warp_of = warp_of.to(dev)
    per_tile = torch.zeros((t_all, 3), dtype=torch.int64, device=dev)

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
      if with_counts:
        per_tile[sl, 0] += active
      if width == 0 or not bool(active.any()):
        if not blending:   # an empty slab leaves lt_end = the carry
          img[:, f] = torch.where(active[:, None],
                                  (carry < 0.0).to(dtype), img[:, f])
        continue
      valid, rows, _ = _slab_rows(table, s0, ln, r0, width, f,
                                  by_slot=mode == "no_sort")
      if walks:
        walk = _warp_walks(rows, ox, oy, config, wr) & valid[..., None]
      if with_counts:
        per_tile[sl, 1] += torch.where(active, valid.sum(1), 0)
        per_tile[sl, 2] += torch.where(active, walk.sum((1, 2)), 0)
      if mode == "no_alpha":
        a = torch.where(walk[..., warp_of], (rows[..., 0] * 1e-6)[..., None],
                        0.0)
      else:
        a = _threshold(_alpha_raw(rows, ox, oy, pxl, pyl, config)[0],
                       config)
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
  if with_counts:
    return out, _group_counts(mapping, per_tile)
  return out


def _uv_forms(rows, ox, oy):
  """The linear forms (lu, lv) of the sigma-scaled rotated coordinates
  over [px, py, 1] (``_backward_alpha_raw``), (C, L) triples: the
  coefficients K2 stages per row."""
  mlx = rows[..., 0] - ox
  mly = rows[..., 1] - oy
  ax, ay = rows[..., 2], rows[..., 3]
  isx = 1.0 / torch.clamp(rows[..., 4], min=1e-12)
  isy = 1.0 / torch.clamp(rows[..., 5], min=1e-12)
  return ((ax * isx, ay * isx, -(mlx * ax + mly * ay) * isx),
          (-ay * isy, ax * isy, (mlx * ay - mly * ax) * isy))


def _backward_alpha_raw(rows, ox, oy, pxl, pyl, config: RasterConfig):
  """(C, L, PIX) raw alpha of the backward and its aux: in antialias mode
  the forward's (``_alpha_raw``); else, as the reference ``_bwd_kernel``
  (:773-784), pa * exp(-(u^2 + v^2) / 2) with aux (lu, lv, u, v): u, v
  the sigma-scaled rotated coordinates, each a linear form l . [px, py,
  1] of the tile-centred pixel coordinates (lu, lv (C, L) triples).

  The forward's quadratic form cancels large terms in f32 for splats
  thinner than ~0.1 px (its exponent's constant grows as 1 / sigma^2):
  with it the backward's f32 gradient of such a splat erred by 2.7e-4 of
  its column's largest against the f64 twin, with u, v by 5.2e-5, the
  reference's figure (ROADMAP F16).  The two formulas agree to rounding,
  so the backward's threshold and freeze decisions can differ from the
  forward's only where a_raw is within rounding of a cut, as the
  reference's do (F1)."""
  if config.antialias:
    return _alpha_raw(rows, ox, oy, pxl, pyl, config)
  lu, lv = _uv_forms(rows, ox, oy)
  u = lu[0][..., None] * pxl + lu[1][..., None] * pyl + lu[2][..., None]
  v = lv[0][..., None] * pxl + lv[1][..., None] * pyl + lv[2][..., None]
  a_raw = rows[..., 6, None] * torch.exp(-0.5 * (u * u + v * v))
  return a_raw, (lu, lv, u, v)


def _row_sums(rows, ox, oy, pxl, pyl, a_raw, aux, ag, z0, config):
  """(C, L) sums over the pixels of the 7 packed-gaussian terms and of the
  split score: K2's shared accumulator before its flush (``_flush_rows``).

  Without antialias, as the reference ``_bwd_kernel`` (:869-914): the
  six pixel moments of z0 * u and z0 * v (times px, py, 1), then z0; the
  flush turns the moments into the six geometry gradients per row.  With
  antialias the six gradients' closed forms per pixel, as in the
  reference."""
  if config.antialias:
    mlx = rows[..., 0] - ox
    mly = rows[..., 1] - oy
    ax, ay = rows[..., 2], rows[..., 3]
    tu, tv = aux
    clamp_live = (a_raw < config.clamp_max_alpha).to(ag.dtype)
    aag = rows[..., 6, None] * ag * clamp_live
    g6 = [aag * d for d in _antialias_grads(
        tu, tv, rows[..., 4, None], rows[..., 5, None],
        pxl - mlx[..., None], pyl - mly[..., None], ax[..., None],
        ay[..., None])]
    split = torch.abs(g6[0]) + torch.abs(g6[1])
    return [g.sum(-1) for g in g6 + [z0]], split.sum(-1)
  lu, lv, u, v = aux
  zu, zv = z0 * u, z0 * v
  sums = [(zu * pxl).sum(-1), (zu * pyl).sum(-1), zu.sum(-1),
          (zv * pxl).sum(-1), (zv * pyl).sum(-1), zv.sum(-1), z0.sum(-1)]
  # the split score per pixel: |z0 d mean_x / d pdf| + |z0 d mean_y / ...|
  split = (torch.abs(zu * lu[0][..., None] + zv * lv[0][..., None])
           + torch.abs(zu * lu[1][..., None] + zv * lv[1][..., None]))
  return sums, split.sum(-1)


def _flush_rows(raw, rows, ox, oy, config: RasterConfig):
  """K2's flush of (C, L, slabw) accumulated rows into gradient rows:
  without antialias the moments become the six geometry gradients with
  the tile's mean offsets (the reference's :882-893), the z0 column is
  divided by pa and the prune column multiplied by pa^2."""
  pa = rows[..., 6]
  if config.antialias:
    g6 = [raw[..., c] for c in range(6)]
  else:
    mlx = rows[..., 0] - ox
    mly = rows[..., 1] - oy
    ax, ay = rows[..., 2], rows[..., 3]
    isx = 1.0 / torch.clamp(rows[..., 4], min=1e-12)
    isy = 1.0 / torch.clamp(rows[..., 5], min=1e-12)
    lu, lv = _uv_forms(rows, ox, oy)
    su_px, su_py, su, sv_px, sv_py, sv = (raw[..., c] for c in range(6))
    su_dx, su_dy = su_px - mlx * su, su_py - mly * su
    sv_dx, sv_dy = sv_px - mlx * sv, sv_py - mly * sv
    suu = lu[0] * su_px + lu[1] * su_py + lu[2] * su
    svv = lv[0] * sv_px + lv[1] * sv_py + lv[2] * sv
    g6 = [ax * isx * su - ay * isy * sv,
          ay * isx * su + ax * isy * sv,
          -isx * su_dx - isy * sv_dy,
          -isx * su_dy + isy * sv_dx,
          isx * suu,
          isy * svv]
  cols = [torch.stack(g6 + [raw[..., 6] / torch.clamp(pa, min=1e-20)], -1),
          raw[..., 7:]]
  if config.compute_point_heuristic:
    cols = [cols[0], raw[..., 7:-2], (raw[..., -2] * (pa * pa))[..., None],
            raw[..., -1:]]
  return torch.cat(cols, -1)


def stream_backward_reference(mapping: StreamMapping,
                              image_tiled: torch.Tensor,
                              g_image_tiled: torch.Tensor,
                              config: RasterConfig, band0: int = 0,
                              halo: bool = False,
                              ablate: str = "") -> torch.Tensor:
  """Plain-torch twin of the stream backward kernel: (T*run_cap + 1,
  slabw) home-major gradient buffer ((T + 2*tiles_wide)*run_cap + 1 rows
  with ``halo``).

  Per chunk of tiles and per slab it recomputes the forward (the same
  gathers, rank order, log transmittance and freeze as
  ``stream_forward_reference``; alpha from ``_backward_alpha_raw``), sums
  every row's gradient terms over the pixels (``_row_sums``: K2's shared
  accumulator), flushes them (``_flush_rows``) and ``index_add_``s each
  row into its home-major buffer row.  Two carries cross slabs, as in the
  reference ``_bwd_kernel``: the frozen log transmittance and the running
  sum of w * (features . g_image).

  ``ablate`` as in ``stream_backward``: skeleton fills each staged row's
  accumulator with 1e-20 * the sequential sum of its 8 + F table values
  and walks nothing; no_sort orders by slot; no_grad fills every row's
  with 1e-20 * the tile's sum of alpha_grad; no_copyback flushes nothing
  and returns 1e-20 * the sum of every accumulator in row 0, column 0."""
  mode = _ablation(ablate, BWD_ABLATIONS, "stream_backward")
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
  used = _used_slabs(mapping)
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
  acc_total = buf.new_zeros(())          # no_copyback

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
                                     grow0[sl, s], by_slot=mode == "no_sort")
      keep = valid & active[:, None] & (grow >= 0) & (grow < r_rows)
      if mode == "skeleton":               # no walk: the carries stay
        sums = rows[..., 0]
        for c in range(1, 8 + f):
          sums = sums + rows[..., c]
        raw = (sums * 1e-20)[..., None].expand(-1, -1, slabw)
        buf.index_add_(0, grow[keep], _flush_rows(raw, rows, ox, oy,
                                                  config)[keep])
        continue
      a_raw, aux = _backward_alpha_raw(rows, ox, oy, pxl, pyl, config)
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
      if mode == "no_grad":
        raw = (ag.sum((1, 2)) * 1e-20)[:, None, None].expand(
            -1, rows.shape[1], slabw)
      else:
        sums, split = _row_sums(rows, ox, oy, pxl, pyl, a_raw, aux, ag, z0,
                                config)
        raw = [torch.stack(sums, -1),
               torch.einsum("clp,cfp->clf", w, gi[:, :f])]
        if with_vis:
          raw.append(w.sum(-1)[..., None])
        if heur:
          raw.append(torch.stack([(ag * ag).sum(-1), split], -1))
        raw = torch.cat(raw, -1)                              # (C, L, slabw)
      if mode == "no_copyback":
        acc_total += torch.where(valid & active[:, None], raw.sum(-1),
                                 0.0).sum()
      else:
        buf.index_add_(0, grow[keep], _flush_rows(raw, rows, ox, oy,
                                                  config)[keep])

      lt_end = carry + csum[:, -1]
      new_carry = torch.maximum(
          lt_end, torch.where(lt <= lcut, lt, _NEG_BIG).max(1).values)
      carry = torch.where(active[:, None], new_carry, carry)
      s_prev = torch.where(active[:, None], s_prev + wgf.sum(1), s_prev)
  if mode == "no_copyback":
    buf[0, 0] = acc_total * 1e-20
  return buf


def profile_gate(got: torch.Tensor, want: torch.Tensor, kernel: str,
                 ablate: str) -> tuple:
  """A profiling mode's kernel output ``got`` against its twin's ``want``:
  (max abs error, the largest share of its tolerance used; above 1 is a
  mismatch).  Channels (K1) and columns (K2) are axis 1.

  K1 (``kernel`` "stream_forward"): skeleton (the floor probe) bit for
  bit; no_alpha, whose image is faint (alphas 1e-6 x a table column), per
  channel to 1e-4 x max |twin channel|; every other mode to K1's gate,
  1e-4.  K2: the default and no_sort to K2's gate per column, 1e-4 x
  max |twin column| + 1e-6; skeleton and no_grad per column to 1e-4
  (skeleton) or 1e-3 (no_grad: tile sums of alpha_grad, order-dependent
  sums with cancellation) x max |twin column|, with no absolute floor
  since every value is scaled by 1e-20; no_copyback its one value
  (1e-20 x the sum of every accumulator, summed over blocks in a varying
  order) to 1e-3 relative, every other entry zero.  A twin of zeros, a value that is
  not finite or a shape that differs is a mismatch."""
  mode = _ablation(ablate, FWD_ABLATIONS if kernel == "stream_forward"
                   else BWD_ABLATIONS, kernel)
  if (got.shape != want.shape or not bool(torch.isfinite(got).all())
      or not bool(want.any())):
    return math.inf, math.inf
  err = (got - want).abs()
  if kernel == "stream_forward" and mode == "skeleton":
    return float(err.max()), 0.0 if torch.equal(got, want) else math.inf
  if mode == "no_copyback":
    if bool(got.flatten()[1:].any()):
      return float(err.max()), math.inf
    e0 = float(err[0, 0])
    return e0, e0 / (1e-3 * abs(float(want[0, 0])))
  scale = want.abs().transpose(0, 1).flatten(1).amax(1)
  if kernel == "stream_forward":
    tol = 1e-4 * scale if mode == "no_alpha" else torch.full_like(scale, 1e-4)
  else:
    tol = (1e-4 * scale + 1e-6 if mode in ("", "no_sort")
           else (1e-4 if mode == "skeleton" else 1e-3) * scale)
  err_col = err.transpose(0, 1).flatten(1).amax(1)
  used = torch.where(err_col > 0, err_col / tol, 0.0)
  return float(err_col.max()), float(used.max())


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
# the register instantiation that has a floor probe and the profiling
# modes (the headline's), and K2's that has the profiling modes
FLOOR_WIDTH = 4
K2_PROFILE_WIDTH = 6


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


# K2 aims at three blocks an SM: its register instantiations' 72-80
# registers a thread allow three of 256 threads; a slab that does not fit
# is staged in chunks of at least K5's 128 rows
K2_BLOCKS = 3
K2_MIN_CHUNK = 128


def _backward_smem(f: int, slab_cap: int, chunk: int, w_max: int, slabw: int,
                   threads: int, mf: int) -> int:
  return 4 * (_sort_cap(slab_cap) + (12 + f) * chunk
              + slabw * acc_stride(chunk) + 8 * w_max + 2
              + (f * threads if mf == 0 else 0))


@functools.cache
def stream_backward_chunk(f: int, slab_cap: int, w_max: int, slabw: int,
                          tile_area: int) -> int:
  """Rows of a slab K2 stages at once: of the whole slab and the multiples
  of 32 from ``K2_MIN_CHUNK`` below it, the largest whose shared memory
  holds the most blocks an SM, up to ``K2_BLOCKS``.  So a slab that fits
  three blocks is one chunk (the headline's 512 rows at F 3), and the
  heavy scene's 1792 at F 3 goes in chunks of 576.  Where none fits one
  block: the slab (``check_smem`` raises)."""
  threads = block_threads(tile_area)
  mf = instantiation(f, tile_area, K2_WIDTHS)

  def blocks(chunk):
    return min(K2_BLOCKS, blocks_by_smem(_backward_smem(
        f, slab_cap, chunk, w_max, slabw, threads, mf)))
  return max([slab_cap, *range(K2_MIN_CHUNK, slab_cap, 32)],
             key=lambda c: (blocks(c), c))


def stream_backward_plan(f: int, slab_cap: int, w_max: int, slabw: int,
                         tile_area: int) -> KernelPlan:
  """K2's instantiation, threads (the tile's pixels in whole warps) and
  shared memory: the slab's rank keys, per row of a chunk
  (``stream_backward_chunk``) its coefficients and features and the
  [column][row] accumulator, window descriptors and, generic, every
  thread's F image cotangents (``tpu_splat_stream_backward_smem``)."""
  threads = block_threads(tile_area)
  mf = instantiation(f, tile_area, K2_WIDTHS)
  chunk = stream_backward_chunk(f, slab_cap, w_max, slabw, tile_area)
  return KernelPlan(mf, threads, _backward_smem(f, slab_cap, chunk, w_max,
                                                slabw, threads, mf))


@functools.cache
def _kernel():
  """The built library, with its C signatures declared (once)."""
  lib = load_kernel_library("stream_forward.cu")
  lib.tpu_splat_stream_forward.restype = ctypes.c_int
  lib.tpu_splat_stream_forward.argtypes = (
      [ctypes.c_void_p] * 5 + [ctypes.c_int] * 19 + [ctypes.c_float] * 4
      + [ctypes.c_void_p])
  declare_plan_entries(lib, "tpu_splat_stream_forward", 5)
  return lib


def stream_forward(mapping: StreamMapping, config: RasterConfig,
                   band0: int = 0, ablate: str = "",
                   with_counts: bool = False):
  """Forward rasterization over a stream mapping: (T, F+1, PIX).
  ``band0``: the absolute tile band of the mapping's first band (a shard
  of a band-sharded image; 0 otherwise).

  The reference's profiling instruments (on no path of the system):
  ``ablate`` takes one phase out of the kernel ("skeleton": the floor
  probe, ``stream_forward_floor``; "no_assemble": one contiguous range of
  rows a slab in place of the window assembly; "no_sort", or the
  reference's "no_mask": no rank sort, the walk in fetch-slot order;
  "no_alpha": alpha = 1e-6 * the row's first table column, no exp or
  threshold); ``with_counts`` also returns the reference's (G * 8, 128)
  count block (``counts_block``: per tile group the computed (tile, slab)
  iterations, and the rows staged and the (row, warp) pairs the warps
  list).  Both need the ``<FLOOR_WIDTH>`` instantiation and an unsharded
  mapping (ValueError).

  CPU mapping -> ``stream_forward_reference``; CUDA mapping -> the
  ``csrc/stream_forward.cu`` kernel, or an exception."""
  with trace.span("k1"):
    mode = _ablation(ablate, FWD_ABLATIONS, "stream_forward")
    if mode or with_counts:
      _check_profile("stream_forward", band0, False, stream_forward_plan(
          mapping.feature_size, mapping.slab_cap, mapping.w_max,
          config.tile_area).max_features, FLOOR_WIDTH)
    if mapping.table.device.type == "cpu":
      return stream_forward_reference(mapping, config, band0, mode,
                                      with_counts)
    if not mode and not with_counts:
      out = _launch_forward(mapping, config, True, "stream_forward", band0)
      launch_counts["stream_forward"] += 1
      return out
    if mode == "skeleton" and not config.use_alpha_blending:
      raise ValueError("stream_forward floor: blending mode only")
    counts = (torch.zeros((mapping.num_groups, 3), dtype=torch.int32,
                          device=mapping.table.device)
              if with_counts else None)
    out = _launch_forward(mapping, config, mode != "skeleton",
                          f"stream_forward ablate={mode!r}", band0,
                          FWD_ABLATIONS[mode], counts)
    if mode:
      probe_launch_counts[f"stream_forward_{mode}"] += 1
    if with_counts:
      probe_launch_counts["stream_forward_counts"] += 1
      return out, counts_block(counts)
    return out


def _check_profile(name: str, band0: int, halo: bool, width: int,
                   profile_width: int):
  """ValueError unless a profiling mode can run: an unsharded mapping and
  the instantiation the modes are built for."""
  if band0 != 0 or halo:
    raise ValueError(f"{name}: the profiling modes take an unsharded "
                     f"mapping (band0 {band0}, halo {halo})")
  if width != profile_width:
    raise ValueError(f"{name}: the profiling modes are built for the "
                     f"<{profile_width}> instantiation only, these shapes "
                     f"take <{width}>")


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
                    walk: bool, name: str, band0: int = 0, mode: int = 0,
                    counts=None) -> torch.Tensor:
  """Check, plan and launch ``csrc/stream_forward.cu``: the compositing
  kernel, or (``walk`` False) its floor probe; ``mode`` (``FWD_ABLATIONS``)
  and ``counts`` (zeroed (G, 3) int32, filled) its profiling modes."""
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
        None if counts is None else counts.data_ptr(),
        mapping.num_tiles, mapping.tiles_wide, mapping.group_width,
        mapping.num_slabs, mapping.w_max, mapping.strip_cap,
        mapping.slab_cap, mapping.rows_per_block, w_pad, f,
        config.tile_size, int(config.antialias),
        int(config.use_alpha_blending), plan.max_features, plan.threads,
        int(walk), band0, mode, mapping.table.numel() // w_pad,
        config.alpha_threshold,
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
      [ctypes.c_void_p] * 6 + [ctypes.c_int] * 22 + [ctypes.c_float] * 3
      + [ctypes.c_void_p])
  declare_plan_entries(lib, "tpu_splat_stream_backward", 7)
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
                    band0: int = 0, halo: bool = False,
                    ablate: str = "") -> torch.Tensor:
  """Backward rasterization: the (T*run_cap + 1, slabw) home-major
  gradient buffer of ``stream_forward``'s image cotangent.  ``band0`` as
  in ``stream_forward``; with ``halo`` the buffer holds tiles_high + 2
  bands of homes, ((T + 2*tiles_wide)*run_cap + 1, slabw): a halo band
  above the mapping's bands, its own, and a halo band below.  A shard
  (``band0`` > 0) needs the halo: rows homed outside its own bands belong
  to its neighbours.

  ``ablate``, the reference's profiling instrument (on no path of the
  system), takes one phase out of the kernel: "skeleton" (staging, sort
  and flush only: each staged row's accumulator holds 1e-20 * the sum of
  its table values), "no_sort" or the reference's "no_mask" (the walk in
  fetch-slot order), "no_grad" (the walk up to alpha_grad; every row's
  accumulator holds 1e-20 * the tile's sum of it), "no_copyback" (no
  flush: 1e-20 * the sum of the accumulators lands in row 0, column 0).
  It needs the ``<K2_PROFILE_WIDTH, 16>`` instantiation and an unsharded
  mapping (ValueError).

  CPU mapping -> ``stream_backward_reference``; CUDA mapping -> the
  ``csrc/stream_backward.cu`` kernel, or an exception."""
  if band0 != 0 and not halo:
    raise ValueError("stream_backward: band0 > 0 without halo would drop "
                     "the rows homed in the neighbouring shards")
  mode = _ablation(ablate, BWD_ABLATIONS, "stream_backward")
  f = mapping.feature_size
  slabw = slab_width(config, f)
  shapes = (f, mapping.slab_cap, mapping.w_max, slabw, config.tile_area)
  plan = stream_backward_plan(*shapes)
  chunk = stream_backward_chunk(*shapes)
  if mode:
    _check_profile("stream_backward", band0, halo, plan.max_features,
                   K2_PROFILE_WIDTH)
  dev = mapping.table.device
  if dev.type == "cpu":
    return stream_backward_reference(mapping, image_tiled, g_image_tiled,
                                     config, band0, halo, mode)
  if dev.type != "cuda":
    raise ValueError(f"stream_backward: unsupported device {dev}")
  if not config.use_alpha_blending:
    raise ValueError("stream backward: quantile mode has no backward")
  w_pad = _check_kernel_inputs(mapping, config, "stream_backward")
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
  heur = config.compute_point_heuristic
  with_vis = heur or config.compute_visibility
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
        mapping.w_max, mapping.strip_cap, mapping.slab_cap, chunk,
        mapping.rows_per_block, w_pad, f, config.tile_size,
        int(config.antialias), mapping.run_cap, slabw, int(with_vis),
        int(heur), plan.max_features, plan.threads, band0, int(halo),
        BWD_ABLATIONS[mode], config.alpha_threshold, config.clamp_max_alpha,
        _log_cut(config), stream)
  if err != 0:
    raise RuntimeError(f"stream_backward kernel launch failed: CUDA error "
                       f"{err}")
  if mode:
    probe_launch_counts[f"stream_backward_{mode}"] += 1
  else:
    launch_counts["stream_backward"] += 1
    launch_counts["stream_backward_chunked"] += chunk < mapping.slab_cap
  trace.count(k2_chunks=-(-mapping.slab_cap // chunk),
              k2_blocks_per_sm=lambda: _blocks_per_sm(plan))
  return out


@functools.cache
def _blocks_per_sm(plan: KernelPlan) -> int:
  """K2's resident blocks an SM at ``plan``, from the CUDA runtime."""
  return occupancy(_bwd_kernel(), "tpu_splat_stream_backward",
                   plan)["blocks_per_sm"]


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


# ---- the mapper's window descriptors (csrc/stream_map.cu) ----------------

def stream_descriptors_plan(group_width: int, num_slabs: int,
                            w_max: int) -> KernelPlan:
  """The descriptor kernel's threads (a warp a tile of the group, at most
  8 warps) and shared memory: per warp a descriptor row (w_max int4), the
  cell counts (S int64) and the slab plan (S + 1 ints); the group's three
  band strips of (gw + 2) * 16 * S + 1 int32 edges
  (``tpu_splat_stream_descriptors_smem``)."""
  warps = min(group_width, 8)
  strip = (group_width + 2) * 16 * num_slabs + 1
  return KernelPlan(0, 32 * warps, warps * (16 * w_max + 8 * num_slabs
                                            + 4 * (num_slabs + 1))
                    + 12 * strip)


@functools.cache
def _map_kernel():
  """The built descriptor library, with its C signatures declared."""
  lib = load_kernel_library("stream_map.cu")
  lib.tpu_splat_stream_descriptors.restype = ctypes.c_int
  lib.tpu_splat_stream_descriptors.argtypes = (
      [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 3
      + [ctypes.c_void_p])
  declare_plan_entries(lib, "tpu_splat_stream_descriptors", 3)
  return lib


def stream_descriptors(edges_all: torch.Tensor, strip_blk: torch.Tensor, *,
                       tiles_wide: int, tiles_high: int, group_width: int,
                       num_slabs: int, strip_cap: int, slab_cap: int,
                       w_max: int, run_cap: int, rows_per_block: int):
  """``stream_map``'s window descriptors: (desc int32 (G, 1,
  gw*S*w_max*4), int64 [run, chunk, window, slab] overflow), from the
  cell-edge table ``edges_all`` ((tiles * 16 * S + 1,) int64) and the
  groups' strip blocks ``strip_blk`` ((G, 3) int64).  ``slab_cap`` above
  2048 is calibration's unbounded pass (one clamped piece a window).

  CPU tensors -> ``stream_descriptors_reference``; CUDA tensors -> the
  ``csrc/stream_map.cu`` kernel, one launch and no host sync, or an
  exception.  The kernel takes rows_per_block 1, 2 or 4 and strip_cap
  below 2^30 (its edge slices are int32); ValueError only where one
  block's shared memory cannot hold the group's edge slices."""
  kw = dict(tiles_wide=tiles_wide, tiles_high=tiles_high,
            group_width=group_width, num_slabs=num_slabs,
            strip_cap=strip_cap, slab_cap=slab_cap, w_max=w_max,
            run_cap=run_cap, rows_per_block=rows_per_block)
  if edges_all.device.type == "cpu":
    return stream_descriptors_reference(edges_all, strip_blk, **kw)
  name = "stream_descriptors"
  tw, th, gw, s = tiles_wide, tiles_high, group_width, num_slabs
  if gw < 1 or tw % gw or th < 1 or s < 1 or w_max < 1:
    raise ValueError(f"{name}: tiles {tw}x{th}, group width {gw}, "
                     f"{s} slabs, w_max {w_max}")
  if rows_per_block not in (1, 2, 4):
    raise ValueError(f"{name}: rows_per_block {rows_per_block} is not 1, "
                     "2 or 4")
  if not (0 < strip_cap < (1 << 30) and slab_cap > 0 and run_cap > 0):
    raise ValueError(f"{name}: capacities strip {strip_cap}, slab "
                     f"{slab_cap}, run {run_cap} (strip_cap below 2^30)")
  n_groups = th * (tw // gw)
  for label, x, shape in (("edges_all", edges_all, (tw * th * 16 * s + 1,)),
                          ("strip_blk", strip_blk, (n_groups, 3))):
    if x.dtype != torch.int64 or tuple(x.shape) != shape or (
        not x.is_contiguous()) or x.device != edges_all.device:
      raise ValueError(f"{name}: {label} must be a contiguous int64 "
                       f"{shape} tensor on {edges_all.device}, got "
                       f"{tuple(x.shape)} {x.dtype} on {x.device}")
  plan = stream_descriptors_plan(gw, s, w_max)
  check_smem(name, plan, f"group width {gw}, {s} slabs, w_max {w_max}")
  dev = edges_all.device
  if dev.type != "cuda":
    raise ValueError(f"{name}: unsupported device {dev}")
  desc = torch.empty((n_groups, 1, gw * s * w_max * 4), dtype=torch.int32,
                     device=dev)
  over = torch.zeros(4, dtype=torch.int64, device=dev)
  lib = _map_kernel()
  with launch_stream(dev) as stream:
    err = lib.tpu_splat_stream_descriptors(
        edges_all.data_ptr(), strip_blk.data_ptr(), desc.data_ptr(),
        over.data_ptr(), tw, th, gw, s, w_max, rows_per_block, strip_cap,
        slab_cap, run_cap, stream)
  if err != 0:
    raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
  launch_counts[name] += 1
  return desc, over
