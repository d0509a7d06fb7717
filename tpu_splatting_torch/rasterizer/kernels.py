"""Sorted-pipeline rasterization kernels and their plain twins.

Counterpart of ``tpu_splatting/rasterizer/kernels.py``.

* ``forward`` (K4) composites each tile's chunks front to back and
  returns ``(image_tiled (T+1, F+1, tile_area), vis_chunked (K*g, 1) or
  None)``: channel F is the alpha (weight) image in blending mode and the
  hit mask in quantile mode, row T is a zero dummy tile, and
  ``vis_chunked[k*g + r]`` is the sum over the tile's pixels of row r's
  compositing weight.
* ``backward`` (K5, blending mode) replays the forward and returns the
  per-overlap gradient rows (K*g, 7 + F [+ 2]): [mean, axis, sigma,
  alpha, features(, prune_cost, split_score)]; rows beyond each chunk's
  valid count, and rows of saturated or dummy chunks, are zero.

Chunk k of the mapping holds rows ``sorted_rows[chunk_src[k] + r]`` for
``r < chunk_cnt[k]``; a tile's chunks are contiguous in ``chunk_to_tile``
and carry its log transmittance (and, backward, the running ``s``) from
one to the next.  Saturation is a freeze: once a pixel's log
transmittance is at or below ``log(1 - saturate_threshold)`` nothing
behind it composites, in both passes.

A CUDA tensor goes to the hand-written kernels in ``csrc/sorted_forward.cu``
and ``csrc/sorted_backward.cu`` (built at first use; the instantiation and
block from ``sorted_forward_plan`` / ``sorted_backward_plan``, any feature
count and tile size up to 32, a ValueError with the bytes only where one
block's shared memory cannot hold the shapes; each launch counted in
``launch_counts``), a CPU tensor to the ``*_reference`` twin, the same
function in plain torch vectorised over tiles with a loop over each
tile's chunks.  There is no fallback between the two.

Both compute alpha with the reference forward's six quadratic-form
coefficients (``_qf_alpha_raw``; antialias: ``_antialias_pdf``), evaluated
term by term, and the log transmittance as the carry plus the sequential
sum of the chunk's ``log1p(-a)``, so kernel and twin make the same
threshold and freeze decisions (ROADMAP F7).  The TPU contracts features
at ``Precision.DEFAULT`` (one bf16 pass); the port computes them in f32,
as the reference's interpret mode does.
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

_NEG_BIG = -3.0e38   # "log 0" fill that stays finite in f32 arithmetic

# kernel launches per wrapper; only the wrapper's launch site adds to it
launch_counts = {"sorted_forward": 0, "sorted_backward": 0}


def reset_launch_counts():
  for k in launch_counts:
    launch_counts[k] = 0


def _log_cut(config: RasterConfig) -> float:
  """log(1 - saturate_threshold): the freeze cut in log space.  A
  non-positive cut (saturate_threshold >= 1) disables freezing."""
  cut = 1.0 - config.saturate_threshold
  return math.log(cut) if cut > 0.0 else _NEG_BIG


def _pixel_basis(pix: int, tile_size: int, dtype, device):
  """Tile-local pixel-centre coordinates (pxl, pyl), each (PIX,)."""
  p = torch.arange(pix, device=device)
  return ((p % tile_size).to(dtype) + 0.5,
          (p // tile_size).to(dtype) + 0.5)


def _qf_alpha_raw(mlx, mly, ax, ay, sx, sy, point_alpha, pxl, pyl):
  """Raw compositing alpha ``point_alpha * pdf`` as one exp of a quadratic
  form in the pixel coordinates with log(point_alpha) folded into the
  constant term.  Null (all-zero) rows give exp(log 1e-30) ~ 0."""
  isx2 = 1.0 / torch.clamp(sx * sx, min=1e-24)
  isy2 = 1.0 / torch.clamp(sy * sy, min=1e-24)
  a2 = ax * ax
  b2 = ay * ay
  cxx = -0.5 * (a2 * isx2 + b2 * isy2)
  cyy = -0.5 * (b2 * isx2 + a2 * isy2)
  cxy = -(ax * ay * (isx2 - isy2))
  c_px = -(2.0 * cxx * mlx + cxy * mly)
  c_py = -(2.0 * cyy * mly + cxy * mlx)
  c_1 = (cxx * mlx * mlx + cxy * mlx * mly + cyy * mly * mly
         + torch.log(torch.clamp(point_alpha, min=1e-30)))
  return torch.exp(cxx * (pxl * pxl) + cxy * (pxl * pyl) + cyy * (pyl * pyl)
                   + c_px * pxl + c_py * pyl + c_1)


def _lin_uv(mlx, mly, ax, ay, sx, sy, scale: bool):
  """Coefficients (c_px, c_py, c_1) of the linear forms u and v over the
  pixel coordinates.  With ``scale`` the 1/sigma factors are applied
  (standard frame coordinates); without, u and v are unscaled (the
  antialias form)."""
  isx = 1.0 / torch.clamp(sx, min=1e-12) if scale else 1.0
  isy = 1.0 / torch.clamp(sy, min=1e-12) if scale else 1.0
  lu = (ax * isx, ay * isx, -(mlx * ax + mly * ay) * isx)
  lv = (-ay * isy, ax * isy, (mlx * ay - mly * ax) * isy)
  return lu, lv


def _apply(lin, pxl, pyl):
  return lin[0] * pxl + lin[1] * pyl + lin[2]


def _clamp_threshold(a_raw, config: RasterConfig, valid_row):
  """Clamp + threshold; rows beyond the chunk's valid count get alpha 0,
  which zeroes their weight, visibility and every gradient."""
  return torch.where((a_raw > config.alpha_threshold) & valid_row,
                     torch.clamp(a_raw, max=config.clamp_max_alpha), 0.0)


def _s_sig(x, s):
  z = x / s
  return 1.0 / (1.0 + torch.exp(-1.6 * z - 0.07 * z * z * z))


def _antialias_pdf(tu, tv, sx, sy):
  """Pixel-integrated pdf; tu / tv are unscaled frame coordinates."""
  ix = sx * (_s_sig(tu + 0.5, sx) - _s_sig(tu - 0.5, sx))
  iy = sy * (_s_sig(tv + 0.5, sy) - _s_sig(tv - 0.5, sy))
  return 2.0 * math.pi * ix * iy


def _antialias_grads(tu, tv, sx, sy, dx, dy, ax, ay):
  """Gradients of the antialiased pixel integral 2 pi ix iy with respect
  to (mean x, mean y, axis x, axis y, sigma x, sigma y)."""
  tau = 2.0 * math.pi
  # null padding rows have sigma 0: clamp so z stays finite
  sx = torch.clamp(sx, min=1e-12)
  sy = torch.clamp(sy, min=1e-12)

  def s_grads(x, sig):
    z = x / sig
    s_val = 1.0 / (1.0 + torch.exp(-1.6 * z - 0.07 * z * z * z))
    ds_dx = (1.6 + 0.21 * z * z) * s_val * (1.0 - s_val)
    d_dx = ds_dx / sig
    return s_val, d_dx, d_dx * -z

  sx1, dx1, dx1s = s_grads(tu + 0.5, sx)
  sx2, dx2, dx2s = s_grads(tu - 0.5, sx)
  sy1, dy1, dy1s = s_grads(tv + 0.5, sy)
  sy2, dy2, dy2s = s_grads(tv - 0.5, sy)
  ix = sx * (sx1 - sx2)
  iy = sy * (sy1 - sy2)
  dsx_t = iy * sx * (dx1 - dx2)
  dsy_t = ix * sy * (dy1 - dy2)
  dmx = tau * (-dsx_t * ax + dsy_t * ay)
  dmy = tau * (-dsx_t * ay - dsy_t * ax)
  dax = tau * (dsx_t * dx + dsy_t * dy)
  day = tau * (dsx_t * dy - dsy_t * dx)
  dsx_ = tau * iy * (sx1 - sx2 + (dx1s - dx2s) * sx)
  dsy_ = tau * ix * (sy1 - sy2 + (dy1s - dy2s) * sy)
  return dmx, dmy, dax, day, dsx_, dsy_


def _tile_chunks(chunk_to_tile: torch.Tensor, num_tiles: int):
  """(first (T+1,) int64): tile t owns chunks [first[t], first[t+1])."""
  return torch.searchsorted(
      chunk_to_tile.contiguous(),
      torch.arange(num_tiles + 1, dtype=chunk_to_tile.dtype,
                   device=chunk_to_tile.device), side="left")


class _Chunks:
  """The twins' walk: tiles in batches (``batches``), then chunk j of
  every tile of a batch at once (``chunks``, yielding: which tiles have a
  chunk j, its index k, the valid-row mask (B, g, 1), its rows
  (B, g, 7+F) and their components, mean in tile-local coordinates)."""

  def __init__(self, sorted_rows, chunk_src, chunk_cnt, chunk_to_tile,
               config: RasterConfig, num_tiles: int, tiles_wide: int):
    self.rows, self.src, self.cnt = sorted_rows, chunk_src.long(), chunk_cnt
    self.g, self.pix, self.ts = (config.chunk_size, config.tile_area,
                                 config.tile_size)
    self.num_tiles, self.tiles_wide = num_tiles, tiles_wide
    first = _tile_chunks(chunk_to_tile, num_tiles)
    self.first, self.nch = first[:-1], first[1:] - first[:-1]
    self.batch = max(1, (1 << 23) // (self.g * self.pix))

  def batches(self):
    for t0 in range(0, self.num_tiles, self.batch):
      yield torch.arange(t0, min(t0 + self.batch, self.num_tiles),
                         device=self.rows.device)

  def chunks(self, tiles):
    dtype, dev, g = self.rows.dtype, self.rows.device, self.g
    first, nch = self.first[tiles], self.nch[tiles]
    ox = ((tiles % self.tiles_wide) * self.ts).to(dtype)[:, None, None]
    oy = ((tiles // self.tiles_wide) * self.ts).to(dtype)[:, None, None]
    r = torch.arange(g, device=dev)
    for j in range(int(nch.max()) if tiles.numel() else 0):
      act = nch > j
      k = torch.where(act, first + j, 0)
      valid_row = ((r < self.cnt[k][:, None]) & act[:, None])[..., None]
      rows = self.rows[self.src[k][:, None] + r]              # (B, g, W)
      c = rows[..., None]                                     # (B, g, W, 1)
      parts = (c[:, :, 0] - ox, c[:, :, 1] - oy, c[:, :, 2], c[:, :, 3],
               c[:, :, 4], c[:, :, 5], c[:, :, 6])
      yield act, k, valid_row, rows, parts


def _alpha_raw(parts, pxl, pyl, antialias: bool):
  """(a_raw, aux): raw alpha (B, g, PIX) and, in antialias mode, (tu, tv)."""
  mlx, mly, ax, ay, sx, sy, pa = parts
  if antialias:
    lu, lv = _lin_uv(mlx, mly, ax, ay, sx, sy, scale=False)
    tu, tv = _apply(lu, pxl, pyl), _apply(lv, pxl, pyl)
    return pa * _antialias_pdf(tu, tv, sx, sy), (tu, tv)
  return _qf_alpha_raw(mlx, mly, ax, ay, sx, sy, pa, pxl, pyl), None


def _scan(a, lt_in):
  """(lt_i, lt_end): the log transmittance before each row (the carry
  plus the exclusive sequential sum of log1p(-a)) and after the chunk."""
  cs = torch.cumsum(torch.log1p(-a), 1)
  lt_i = torch.cat([torch.zeros_like(cs[:, :1]), cs[:, :-1]], 1) + lt_in
  return lt_i, lt_in[:, 0] + cs[:, -1]


def _frozen_carry(lt_i, lt_end, lcut):
  """The frozen carry: the first value at or below the cut, else lt_end."""
  return torch.maximum(
      lt_end, torch.where(lt_i <= lcut, lt_i, _NEG_BIG).amax(1))


def forward_reference(sorted_rows, chunk_src, chunk_cnt, chunk_to_tile,
                      config: RasterConfig, num_tiles: int, tiles_wide: int,
                      with_vis: bool = True):
  """Plain-torch twin of ``forward``."""
  walk = _Chunks(sorted_rows, chunk_src, chunk_cnt, chunk_to_tile, config,
                 num_tiles, tiles_wide)
  dtype, dev = sorted_rows.dtype, sorted_rows.device
  f = sorted_rows.shape[1] - 7
  g, pix = walk.g, walk.pix
  blending = config.use_alpha_blending
  lcut = _log_cut(config) if blending else _NEG_BIG
  thr = config.saturate_threshold
  pxl, pyl = _pixel_basis(pix, walk.ts, dtype, dev)
  image = torch.zeros((num_tiles + 1, f + 1, pix), dtype=dtype, device=dev)
  vis = (torch.zeros((chunk_src.shape[0] * g, 1), dtype=dtype, device=dev)
         if with_vis else None)
  r = torch.arange(g, device=dev)

  for tiles in walk.batches():
    lt = torch.zeros((tiles.numel(), pix), dtype=dtype, device=dev)
    img = image[tiles]
    for act, k, valid_row, rows, parts in walk.chunks(tiles):
      a_raw, _ = _alpha_raw(parts, pxl, pyl, config.antialias)
      a = _clamp_threshold(a_raw, config, valid_row)         # (B, g, PIX)
      lt_i, lt_end = _scan(a, lt[:, None])
      t_i = torch.exp(lt_i)
      feats = rows[..., 7:]
      am = act[:, None, None]
      if blending:
        w = torch.where(lt_i > lcut, a * t_i, 0.0)
        contrib = torch.cat([torch.einsum("bgf,bgp->bfp", feats, w),
                             w.sum(1)[:, None]], 1)
        img += torch.where(am, contrib, 0.0)
        lt_new = _frozen_carry(lt_i, lt_end, lcut)
      else:
        # quantile: the feature of the first row whose transmittance
        # crosses the threshold; channel f is the hit mask
        sel = ((t_i * (1.0 - a) <= thr) & (t_i > thr)).to(dtype)
        w = a * t_i
        img[:, :f] += torch.where(am, torch.einsum("bgf,bgp->bfp", feats,
                                                   sel), 0.0)
        lt_new = lt_end
        img[:, f] = torch.where(act[:, None], (lt_new < 0.0).to(dtype),
                                img[:, f])
      lt = torch.where(act[:, None], lt_new, lt)
      if with_vis:
        slot = (k[:, None] * g + r)[act]
        vis[slot, 0] = w.sum(-1)[act]
    image[tiles] = img
  return image, vis


def backward_reference(sorted_rows, image_tiled, g_image_tiled, chunk_src,
                       chunk_cnt, chunk_to_tile, config: RasterConfig,
                       num_tiles: int, tiles_wide: int):
  """Plain-torch twin of ``backward``."""
  walk = _Chunks(sorted_rows, chunk_src, chunk_cnt, chunk_to_tile, config,
                 num_tiles, tiles_wide)
  dtype, dev = sorted_rows.dtype, sorted_rows.device
  f = sorted_rows.shape[1] - 7
  g, pix = walk.g, walk.pix
  heur = config.compute_point_heuristic
  lcut = _log_cut(config)
  cmax = config.clamp_max_alpha
  pxl, pyl = _pixel_basis(pix, walk.ts, dtype, dev)
  out_w = 7 + f + (2 if heur else 0)
  gout = torch.zeros((chunk_src.shape[0] * g, out_w), dtype=dtype,
                     device=dev)
  r = torch.arange(g, device=dev)
  img_all = image_tiled.to(dtype)
  gimg_all = g_image_tiled.to(dtype)

  for tiles in walk.batches():
    gimg = gimg_all[tiles]                                    # (B, F+1, PIX)
    lt = torch.zeros((tiles.numel(), pix), dtype=dtype, device=dev)
    s = (gimg * img_all[tiles]).sum(1)                        # (B, PIX)
    for act, k, valid_row, rows, parts in walk.chunks(tiles):
      mlx, mly, ax, ay, sx, sy, pa = parts
      a_raw, aux = _alpha_raw(parts, pxl, pyl, config.antialias)
      a = _clamp_threshold(a_raw, config, valid_row)
      clamp_live = (a_raw < cmax).to(dtype)
      lt_i, lt_end = _scan(a, lt[:, None])
      t_i = torch.exp(lt_i)
      mask = ((lt_i > lcut) & (a > 0.0)).to(dtype)
      w = a * t_i * mask
      feats = rows[..., 7:]
      gf = torch.einsum("bgf,bfp->bgp", feats, gimg[:, :f]) + gimg[:, None, f]
      wgf = w * gf
      s_i = s[:, None] - torch.cumsum(wgf, 1)       # inclusive of the row
      alpha_grad = (t_i * gf - s_i / (1.0 - a)) * mask
      z0 = alpha_grad * clamp_live * a_raw

      if config.antialias:
        aag = pa * alpha_grad * clamp_live
        tu, tv = aux
        d6 = _antialias_grads(tu, tv, sx, sy, pxl - mlx, pyl - mly, ax, ay)
        geo = [(aag * d).sum(-1) for d in d6]
        split_px = torch.abs(aag * d6[0]) + torch.abs(aag * d6[1])
      else:
        # through pixel moments of z0*u and z0*v, as the reference
        lu, lv = _lin_uv(mlx, mly, ax, ay, sx, sy, scale=True)
        isx = 1.0 / torch.clamp(sx, min=1e-12)
        isy = 1.0 / torch.clamp(sy, min=1e-12)
        u, v = _apply(lu, pxl, pyl), _apply(lv, pxl, pyl)
        zu, zv = z0 * u, z0 * v
        su, su_px, su_py = (zu.sum(-1, keepdim=True),
                            (zu * pxl).sum(-1, keepdim=True),
                            (zu * pyl).sum(-1, keepdim=True))
        sv, sv_px, sv_py = (zv.sum(-1, keepdim=True),
                            (zv * pxl).sum(-1, keepdim=True),
                            (zv * pyl).sum(-1, keepdim=True))
        su_dx, su_dy = su_px - mlx * su, su_py - mly * su
        sv_dx, sv_dy = sv_px - mlx * sv, sv_py - mly * sv
        suu = lu[0] * su_px + lu[1] * su_py + lu[2] * su
        svv = lv[0] * sv_px + lv[1] * sv_py + lv[2] * sv
        geo = [g_[..., 0] for g_ in (
            ax * isx * su - ay * isy * sv, ay * isx * su + ax * isy * sv,
            -isx * su_dx - isy * sv_dy, -isx * su_dy + isy * sv_dx,
            isx * suu, isy * svv)]
        dmx_u = u * (isx * ax) - v * (isy * ay)
        dmy_u = u * (isx * ay) + v * (isy * ax)
        split_px = torch.abs(z0 * dmx_u) + torch.abs(z0 * dmy_u)

      g_pa = z0.sum(-1) / torch.clamp(pa[..., 0], min=1e-20)
      cols = geo + [g_pa]
      vals = [torch.stack(cols, -1),
              torch.einsum("bgp,bfp->bgf", w, gimg[:, :f])]
      if heur:
        aag_h = pa * alpha_grad
        vals.append(torch.stack([(aag_h * aag_h).sum(-1),
                                 split_px.sum(-1)], -1))
      slot = (k[:, None] * g + r)[act]
      gout[slot] = torch.cat(vals, -1)[act]

      lt = torch.where(act[:, None], _frozen_carry(lt_i, lt_end, lcut), lt)
      s = torch.where(act[:, None], s_i[:, -1], s)
  return gout


# register instantiations (most features) of csrc/sorted_forward.cu and
# csrc/sorted_backward.cu; more features take the generic one
K4_WIDTHS = (8, 24, 56)
K5_WIDTHS = (7, 23, 56)


def sorted_forward_plan(f: int, chunk_size: int,
                        tile_area: int) -> KernelPlan:
  """K4's instantiation, threads (the tile's pixels in whole warps) and
  shared memory: per-row coefficients and features, one visibility
  partial per warp and row and, generic, every thread's F accumulators
  (``tpu_splat_sorted_forward_smem``)."""
  threads = block_threads(tile_area)
  mf = instantiation(f, tile_area, K4_WIDTHS)
  smem = 4 * (chunk_size * (7 + f + threads // 32)
              + (f * threads if mf == 0 else 0))
  return KernelPlan(mf, threads, smem)


def sorted_backward_plan(f: int, chunk_size: int, out_w: int,
                         tile_area: int) -> KernelPlan:
  """K5's instantiation, threads (the tile's pixels in whole warps) and
  shared memory: per-row coefficients and features, the [column][row]
  accumulator and, generic, every thread's F image cotangents
  (``tpu_splat_sorted_backward_smem``)."""
  threads = block_threads(tile_area)
  mf = instantiation(f, tile_area, K5_WIDTHS)
  smem = 4 * (chunk_size * (13 + f) + out_w * acc_stride(chunk_size)
              + (f * threads if mf == 0 else 0))
  return KernelPlan(mf, threads, smem)


def _check_inputs(name, sorted_rows, chunk_src, chunk_cnt, chunk_to_tile,
                  config: RasterConfig, num_tiles: int):
  dev = sorted_rows.device
  if sorted_rows.dtype != torch.float32:
    raise TypeError(f"{name} kernel: sorted_rows must be torch.float32, got "
                    f"{sorted_rows.dtype}")
  if sorted_rows.dim() != 2 or sorted_rows.shape[1] < 8:
    raise ValueError(f"{name}: sorted_rows shape {tuple(sorted_rows.shape)}")
  k = chunk_to_tile.shape[0]
  for field, x in (("chunk_src", chunk_src), ("chunk_cnt", chunk_cnt),
                   ("chunk_to_tile", chunk_to_tile)):
    if x.device != dev:
      raise ValueError(f"{name}: {field} on {x.device}, rows on {dev}")
    if x.dtype != torch.int32:
      raise TypeError(f"{name}: {field} must be torch.int32, got {x.dtype}")
    if tuple(x.shape) != (k,):
      raise ValueError(f"{name}: {field} shape {tuple(x.shape)}, expected "
                       f"({k},)")
  if config.tile_area > 1024:
    raise ValueError(f"{name} kernel: tile_size {config.tile_size}: one "
                     "thread per pixel allows at most 1024 pixels per tile")
  if num_tiles <= 0:
    raise ValueError(f"{name}: num_tiles {num_tiles}")


@functools.cache
def _fwd_kernel():
  lib = load_kernel_library("sorted_forward.cu")
  lib.tpu_splat_sorted_forward.restype = ctypes.c_int
  lib.tpu_splat_sorted_forward.argtypes = (
      [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_float] * 4
      + [ctypes.c_void_p])
  declare_plan_entries(lib, "tpu_splat_sorted_forward", 4)
  return lib


def forward(sorted_rows: torch.Tensor, chunk_src: torch.Tensor,
            chunk_cnt: torch.Tensor, chunk_to_tile: torch.Tensor,
            config: RasterConfig, num_tiles: int, tiles_wide: int,
            with_vis: bool = True):
  """Rasterize the sorted overlap rows, windowed per chunk: (image_tiled
  (T+1, F+1, PIX), vis_chunked (K*g, 1) or None).

  CPU tensors -> ``forward_reference``; CUDA tensors -> the
  ``csrc/sorted_forward.cu`` kernel, or an exception."""
  dev = sorted_rows.device
  if dev.type == "cpu":
    return forward_reference(sorted_rows, chunk_src, chunk_cnt,
                             chunk_to_tile, config, num_tiles, tiles_wide,
                             with_vis)
  if dev.type != "cuda":
    raise ValueError(f"sorted forward: unsupported device {dev}")
  _check_inputs("sorted forward", sorted_rows, chunk_src, chunk_cnt,
                chunk_to_tile, config, num_tiles)
  sorted_rows = sorted_rows.contiguous()
  f = sorted_rows.shape[1] - 7
  g, pix = config.chunk_size, config.tile_area
  plan = sorted_forward_plan(f, g, pix)
  check_smem("sorted forward", plan, f"chunk_size {g}, {f} features, {pix} "
             "pixels")
  lib = _fwd_kernel()
  first = _tile_chunks(chunk_to_tile, num_tiles).to(torch.int32)
  image = torch.empty((num_tiles + 1, f + 1, pix), dtype=torch.float32,
                      device=dev)
  image[num_tiles].zero_()
  vis = (torch.zeros((chunk_src.shape[0] * g, 1), dtype=torch.float32,
                     device=dev) if with_vis else None)
  blending = config.use_alpha_blending
  with launch_stream(dev) as stream:
    err = lib.tpu_splat_sorted_forward(
        sorted_rows.data_ptr(), chunk_src.data_ptr(), chunk_cnt.data_ptr(),
        first.data_ptr(), image.data_ptr(),
        vis.data_ptr() if with_vis else None,
        num_tiles, tiles_wide, sorted_rows.shape[1], f, g, config.tile_size,
        int(config.antialias), int(blending), plan.max_features,
        plan.threads, config.alpha_threshold,
        config.clamp_max_alpha, _log_cut(config) if blending else _NEG_BIG,
        config.saturate_threshold, stream)
  if err != 0:
    raise RuntimeError(f"sorted forward kernel launch failed: CUDA error "
                       f"{err}")
  launch_counts["sorted_forward"] += 1
  return image, vis


@functools.cache
def _bwd_kernel():
  lib = load_kernel_library("sorted_backward.cu")
  lib.tpu_splat_sorted_backward.restype = ctypes.c_int
  lib.tpu_splat_sorted_backward.argtypes = (
      [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_float] * 3
      + [ctypes.c_void_p])
  declare_plan_entries(lib, "tpu_splat_sorted_backward", 5)
  return lib


def backward(sorted_rows: torch.Tensor, image_tiled: torch.Tensor,
             g_image_tiled: torch.Tensor, chunk_src: torch.Tensor,
             chunk_cnt: torch.Tensor, chunk_to_tile: torch.Tensor,
             config: RasterConfig, num_tiles: int, tiles_wide: int):
  """Per-overlap gradient rows (K*g, 7 + F [+ 2]) in chunk layout, to be
  reduced to points by the caller.

  CPU tensors -> ``backward_reference``; CUDA tensors -> the
  ``csrc/sorted_backward.cu`` kernel, or an exception."""
  dev = sorted_rows.device
  if dev.type == "cpu":
    return backward_reference(sorted_rows, image_tiled, g_image_tiled,
                              chunk_src, chunk_cnt, chunk_to_tile, config,
                              num_tiles, tiles_wide)
  if dev.type != "cuda":
    raise ValueError(f"sorted backward: unsupported device {dev}")
  if not config.use_alpha_blending:
    raise ValueError("sorted backward: quantile mode has no backward")
  _check_inputs("sorted backward", sorted_rows, chunk_src, chunk_cnt,
                chunk_to_tile, config, num_tiles)
  f = sorted_rows.shape[1] - 7
  g, pix = config.chunk_size, config.tile_area
  for name, x in (("image_tiled", image_tiled),
                  ("g_image_tiled", g_image_tiled)):
    if x.device != dev:
      raise ValueError(f"sorted backward: {name} on {x.device}, rows on "
                       f"{dev}")
    if x.dtype != torch.float32:
      raise TypeError(f"sorted backward: {name} must be torch.float32, got "
                      f"{x.dtype}")
    if tuple(x.shape) != (num_tiles + 1, f + 1, pix):
      raise ValueError(f"sorted backward: {name} shape {tuple(x.shape)}, "
                       f"expected {(num_tiles + 1, f + 1, pix)}")
  heur = config.compute_point_heuristic
  out_w = 7 + f + (2 if heur else 0)
  plan = sorted_backward_plan(f, g, out_w, pix)
  check_smem("sorted backward", plan, f"chunk_size {g}, {f} features, "
             f"{out_w} gradient columns, {pix} pixels")
  lib = _bwd_kernel()
  sorted_rows = sorted_rows.contiguous()
  image_tiled = image_tiled.contiguous()
  g_image_tiled = g_image_tiled.contiguous()
  first = _tile_chunks(chunk_to_tile, num_tiles).to(torch.int32)
  gout = torch.zeros((chunk_src.shape[0] * g, out_w), dtype=torch.float32,
                     device=dev)
  with launch_stream(dev) as stream:
    err = lib.tpu_splat_sorted_backward(
        sorted_rows.data_ptr(), chunk_src.data_ptr(), chunk_cnt.data_ptr(),
        first.data_ptr(), image_tiled.data_ptr(), g_image_tiled.data_ptr(),
        gout.data_ptr(), num_tiles, tiles_wide, sorted_rows.shape[1], f, g,
        config.tile_size, int(config.antialias), int(heur),
        plan.max_features, plan.threads, config.alpha_threshold,
        config.clamp_max_alpha, _log_cut(config), stream)
  if err != 0:
    raise RuntimeError(f"sorted backward kernel launch failed: CUDA error "
                       f"{err}")
  launch_counts["sorted_backward"] += 1
  return gout
