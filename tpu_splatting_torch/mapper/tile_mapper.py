"""Tile mapping of the sorted-overlap pipeline, and the tile-grid helpers.

Counterpart of ``tpu_splatting/mapper/tile_mapper.py``, plain torch.
``map_to_tiles`` assigns depth-sorted splats to image tiles with static
capacities: every splat tests a ``tile_window``^2 window of candidate
tiles against its oriented ellipse, splats spanning more tiles take a
"big" path with a wider window and a fixed capacity, and one stable sort
of ``(tile << 16 | depth16)`` keys orders the candidates tile-major.
Overflow is counted in ``num_overflow``, never silently rendered wrong.

The reference lets the point and feature rows ride its sorts as payload
operands (cheap on the TPU); here each sort yields a permutation and the
rows are gathered by it, which gives the same rows in the same order.
Both sorts are stable, as ``lax.sort`` is, so the integer fields match
the reference exactly.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..data_types import RasterConfig
from ..lib import gaussian2d as g2d

_SENTINEL_KEY = 0xFFFFFFFF     # non-hit candidates sort last


def pad_to_tile(image_size: Tuple[int, int], tile_size: int):
  """Round an image size up to a tile multiple."""
  return tuple(int(math.ceil(x / tile_size) * tile_size) for x in image_size)


def tile_shape(image_size: Tuple[int, int], tile_size: int) -> Tuple[int, int]:
  """(tiles_wide, tiles_high) for an image size."""
  w, h = pad_to_tile(image_size, tile_size)
  return w // tile_size, h // tile_size


def default_max_overlaps(n: int, image_size: Tuple[int, int],
                         config: RasterConfig) -> int:
  """Heuristic static overlap capacity: ~8 overlaps per splat, at least a
  few chunks per tile, rounded to the chunk size."""
  tw, th = tile_shape(image_size, config.tile_size)
  cap = max(8 * n, 4 * tw * th * config.chunk_size, 1 << 16)
  g = config.chunk_size
  return ((cap + g - 1) // g) * g


@dataclass(frozen=True)
class TileMapping:
  """Static-shape tile mapping (fields as the reference's).

    overlap_to_point: (P + 2g,) i32 point index per overlap, sorted by
      (tile, depth); padding entries are ``num_points``.  The trailing
      2 * chunk_size rows are slack so chunk windows stay in bounds.
    tile_ranges: (T, 2) i32 [start, end) into the sorted overlap list.
    sorted_payload: (P + 2g, 7 + F) packed splat row and feature row per
      overlap, in ``overlap_to_point`` order (None without features).
    chunk_to_tile: (K,) i32 owning tile of each chunk; dummy chunks = T.
    chunk_src: (K,) i32 first row of each chunk's window.
    chunk_cnt: (K,) i32 valid rows of each chunk's window (0 for dummy).
    num_overflow: () i32 overlaps dropped by the capacities (0 = exact).
  """
  overlap_to_point: torch.Tensor
  tile_ranges: torch.Tensor
  sorted_payload: Optional[torch.Tensor]
  chunk_to_tile: torch.Tensor
  chunk_src: torch.Tensor
  chunk_cnt: torch.Tensor
  num_overflow: torch.Tensor

  num_points: int
  num_tiles: int
  tiles_wide: int
  tiles_high: int
  chunk_size: int
  small_window: int
  big_window: int
  feature_size: Optional[int]

  @property
  def num_chunks(self) -> int:
    return self.chunk_to_tile.shape[0]

  @property
  def point_id_chunked(self) -> torch.Tensor:
    """(K * chunk_size,) i32 point id per chunk-aligned slot (null = n)."""
    g = self.chunk_size
    r = torch.arange(g, device=self.chunk_src.device)[None, :]
    src = self.chunk_src.long()[:, None] + r
    valid = r < self.chunk_cnt[:, None]
    pid = self.overlap_to_point[src.reshape(-1)].reshape(-1, g)
    return torch.where(valid, pid, self.num_points).reshape(-1).to(
        torch.int32)


def _obb_axes(axis, sigma, gscale, tile_size):
  """Rows of the image -> ellipse transform, ``axis_i / (sigma_i *
  gscale)``, and each row's tile half-extent ``(|u_x| + |u_y|) * ts / 2``:
  a tile projects onto row u as ``u . centre +- e``."""
  scale = torch.clamp(sigma * gscale[:, None], min=1e-12)
  u1 = axis / scale[:, 0:1]
  u2 = g2d.perp(axis) / scale[:, 1:2]
  e1 = (torch.abs(u1[:, 0]) + torch.abs(u1[:, 1])) * (tile_size * 0.5)
  e2 = (torch.abs(u2[:, 0]) + torch.abs(u2[:, 1])) * (tile_size * 0.5)
  return u1, u2, e1, e2


def _tile_bounds(mean, axis, sigma, gscale, image_size, tile_size):
  """Conservative tile range [min_tile, max_tile) of each splat (int64)."""
  lower, upper = g2d.ellipse_bounds(
      mean, axis * (sigma[:, 0] * gscale)[:, None],
      g2d.perp(axis) * (sigma[:, 1] * gscale)[:, None])
  max_tile = torch.tensor([(image_size[0] - 1) // tile_size,
                           (image_size[1] - 1) // tile_size],
                          dtype=torch.int64, device=mean.device)
  min_tile = torch.clamp(torch.floor(lower / tile_size).to(torch.int64),
                         min=0)
  max_tile_b = torch.ceil(upper / tile_size).to(torch.int64)
  max_tile_b = torch.minimum(torch.maximum(max_tile_b, min_tile + 1),
                             max_tile + 1)
  return min_tile, max_tile_b


def _candidate_hits(mean, u1, u2, e1, e2, min_tile, span, valid,
                    window: int, tile_size: int, tiles_wide: int):
  """Test a window^2 candidate grid per splat: (hit (N, W^2) bool,
  tile_id (N, W^2) int64).  Candidate j covers tile
  ``min_tile + (j % W, j // W)``; candidates outside the span miss."""
  offs = torch.arange(window, dtype=torch.int64, device=mean.device)
  off_x = offs.repeat(window)               # fastest-varying x
  off_y = offs.repeat_interleave(window)

  tile_x = min_tile[:, 0:1] + off_x[None, :]
  tile_y = min_tile[:, 1:2] + off_y[None, :]
  in_span = (off_x[None, :] < span[:, 0:1]) & (off_y[None, :] < span[:, 1:2])

  # tile centre relative to the splat's mean
  cx = (tile_x.to(mean.dtype) + 0.5) * tile_size - mean[:, 0:1]
  cy = (tile_y.to(mean.dtype) + 0.5) * tile_size - mean[:, 1:2]
  t1 = u1[:, 0:1] * cx + u1[:, 1:2] * cy
  t2 = u2[:, 0:1] * cx + u2[:, 1:2] * cy

  hit = ((torch.abs(t1) <= 1.0 + e1[:, None])
         & (torch.abs(t2) <= 1.0 + e2[:, None]) & in_span & valid[:, None])
  return hit, tile_x + tile_y * tiles_wide


def _marker_fill(values: torch.Tensor, positions: torch.Tensor,
                 size: int) -> torch.Tensor:
  """Piecewise-constant fill: out[s] = values[t] for the largest t with
  positions[t] <= s (positions and values nondecreasing, values >= 0): a
  scatter-max that drops positions >= size, then a running max."""
  buf = torch.zeros(size + 1, dtype=values.dtype, device=values.device)
  pos = torch.where((positions >= 0) & (positions < size), positions, size)
  buf.scatter_reduce_(0, pos.long(), values, reduce="amax")
  return torch.cummax(buf[:size], 0).values


def _valid_points(gaussians, depth, config: RasterConfig):
  mean, axis, sigma, alpha = g2d.unpack_g2d(gaussians)
  gscale = g2d.gaussian_scale(alpha, config.alpha_threshold)
  valid = (alpha > config.alpha_threshold) & (depth > 0) & (gscale > 0)
  return mean, axis, sigma, gscale, valid


def calibrate_mapper(gaussians: torch.Tensor, depth: torch.Tensor,
                     image_size: Tuple[int, int],
                     config: RasterConfig) -> dict:
  """One N-sized dry pass over a representative scene: measured
  statistics and suggested static capacities (the reference's dict).

    tile_window: smallest window covering >= 99.9% of valid points (<= 8).
    big_capacity: 1.5x the count of points wider than that window.
    max_overlaps: 1.15x the exact OBB hit count at that window plus an
      upper bound for big-path candidates, chunk aligned.
  """
  ts = config.tile_size
  tw, _ = tile_shape(image_size, ts)
  padded_size = pad_to_tile(image_size, ts)
  with torch.no_grad():
    mean, axis, sigma, gscale, valid = _valid_points(
        gaussians, depth.reshape(-1), config)
    min_tile, max_tile = _tile_bounds(mean, axis, sigma, gscale,
                                      padded_size, ts)
    span_xy = max_tile - min_tile
    span = torch.where(valid, span_xy.max(-1).values, 0).cpu().numpy()
    n_valid = max(int(valid.sum()), 1)
    window = (int(np.quantile(span[span > 0], 0.999))
              if (span > 0).any() else 1)
    window = max(min(window, 8), 1)
    n_wide = int((span > window).sum())

    u1, u2, e1, e2 = _obb_axes(axis, sigma, gscale, ts)
    wide = valid & torch.any(span_xy > window, -1)
    hit, _ = _candidate_hits(mean, u1, u2, e1, e2, min_tile, span_xy,
                             valid & ~wide, window, ts, tw)
    big_ub = torch.where(
        wide, torch.prod(torch.clamp(span_xy, max=config.big_tile_window),
                         -1), 0)
    total = int(hit.sum()) + int(big_ub.sum())
  g = config.chunk_size
  cap = int(total * 1.15) + 4 * g
  return {
      "tile_window": window,
      "big_capacity": max(1024, int(n_wide * 1.5 + 0.5)),
      "max_overlaps": ((cap + g - 1) // g) * g,
      "measured_hits_upper_bound": total,
      "num_wide": n_wide,
      "num_valid": n_valid,
  }


def map_to_tiles(gaussians: torch.Tensor, depth: torch.Tensor,
                 image_size: Tuple[int, int], config: RasterConfig,
                 max_overlaps: Optional[int] = None,
                 use_depth16: bool = False,
                 features: Optional[torch.Tensor] = None) -> TileMapping:
  """Map packed 2D splats to depth-sorted per-tile overlap lists.

    gaussians: (N, 7) packed splats; depth: (N,) or (N, 1) NDC depth,
      <= 0 marks culled points; image_size: (width, height).
    max_overlaps: static overlap capacity (default: heuristic).
    use_depth16: accepted for the reference's signature; among small
      splats the stable depth presort gives exact f32 depth order either
      way, and big-path candidates always interleave at 16-bit depth.
    features: optional (N, F); the point and feature rows then come out
      in overlap order as ``sorted_payload``.

  Non-differentiable: callers pass detached inputs.
  """
  del use_depth16
  dev = gaussians.device
  n = gaussians.shape[0]
  depth = depth.reshape(n)
  ts = config.tile_size
  tw, th = tile_shape(image_size, ts)
  num_tiles = tw * th
  assert num_tiles < 65535, (
      f"tile count {num_tiles} exceeds 16-bit id budget; increase tile_size")
  g = config.chunk_size
  padded_size = pad_to_tile(image_size, ts)
  if max_overlaps is None:
    max_overlaps = default_max_overlaps(n, image_size, config)
  p_cap = ((max_overlaps + g - 1) // g) * g

  if features is not None:
    assert features.shape[0] == n, features.shape
    f_size = features.shape[1]
    row_payload = torch.cat([gaussians, features.to(gaussians.dtype)], -1)
  else:
    f_size = None
    row_payload = gaussians

  # depth presort (stable; non-negative f32 depth bits compare as int32)
  dkey = depth.to(torch.float32).contiguous().view(torch.int32)
  orig_pid = torch.sort(dkey, stable=True).indices
  depth = depth[orig_pid]
  row_payload = row_payload[orig_pid]
  gaussians = row_payload[:, :7]

  mean, axis, sigma, gscale, valid = _valid_points(gaussians, depth, config)
  u1, u2, e1, e2 = _obb_axes(axis, sigma, gscale, ts)
  min_tile, max_tile = _tile_bounds(mean, axis, sigma, gscale, padded_size,
                                    ts)
  span = max_tile - min_tile

  w_small = config.tile_window
  is_big = valid & torch.any(span > w_small, -1)
  hit_s, tid_s = _candidate_hits(
      mean, u1, u2, e1, e2, min_tile, span, valid & ~is_big, w_small, ts, tw)

  # big path: the first b_cap big points in depth order, padded with n
  b_cap = config.big_capacity
  w_big = config.big_tile_window
  rank = torch.cumsum(is_big.to(torch.int64), 0) - 1
  slot = torch.where(is_big & (rank < b_cap), rank, b_cap)
  big_idx = torch.full((b_cap + 1,), n, dtype=torch.int64, device=dev)
  big_idx.scatter_(0, slot, torch.arange(n, device=dev))
  big_idx = big_idx[:b_cap]
  big_present = big_idx < n
  big_overflow = torch.clamp(is_big.sum() - b_cap, min=0)

  def gather_pad(x, fill=0):
    return torch.cat([x, torch.full_like(x[:1], fill)], 0)[big_idx]

  span_b_full = gather_pad(span)
  span_b = torch.clamp(span_b_full, max=w_big)
  span_clipped = torch.any(span_b_full > w_big, -1) & big_present
  hit_b, tid_b = _candidate_hits(
      gather_pad(mean), gather_pad(u1), gather_pad(u2), gather_pad(e1),
      gather_pad(e2), gather_pad(min_tile), span_b, big_present, w_big, ts,
      tw)

  # one stable sort of the candidate keys (uint32 values in int64): points
  # are depth-presorted, so a bare tile key gives per-tile depth order;
  # depth16 interleaves the big candidates (appended last) by depth
  def keys(hit, tid, d):
    d16 = (torch.clamp(d.to(torch.float32), 0.0, 1.0) * 65535.0).to(
        torch.int64)
    return torch.where(hit, (tid << 16) | d16[:, None], _SENTINEL_KEY)

  key = torch.cat([keys(hit_s, tid_s, depth).reshape(-1),
                   keys(hit_b, tid_b, gather_pad(depth)).reshape(-1)])
  hit = torch.cat([hit_s.reshape(-1), hit_b.reshape(-1)])
  # presorted point index of every candidate (n for a big slot's padding)
  cand_point = torch.cat([
      torch.arange(n, device=dev).repeat_interleave(w_small * w_small),
      big_idx.repeat_interleave(w_big * w_big)])
  sorted_key, order = torch.sort(key, stable=True)
  order = order[:p_cap]
  sorted_tile = sorted_key[:p_cap] >> 16
  src_point = cand_point[order]
  pid_ext = torch.cat([orig_pid, torch.full_like(orig_pid[:1], n)])
  pid = torch.where(hit[order], pid_ext[src_point], n)
  overlap_to_point = torch.cat([
      pid, torch.full((2 * g,), n, dtype=torch.int64, device=dev)]).to(
          torch.int32)

  sorted_payload = None
  if features is not None:
    rows_ext = torch.cat([row_payload, torch.zeros_like(row_payload[:1])])
    sorted_payload = torch.cat([
        rows_ext[src_point], row_payload.new_zeros((2 * g, 7 + f_size))])

  total = hit_s.sum() + hit_b.sum()
  num_overflow = (torch.clamp(total - p_cap, min=0) + big_overflow
                  + span_clipped.sum()).to(torch.int32)

  # per-tile ranges: one searchsorted over T+1 edges
  tile_ids = torch.arange(num_tiles, dtype=torch.int64, device=dev)
  edges = torch.searchsorted(
      sorted_tile, torch.arange(num_tiles + 1, dtype=torch.int64,
                                device=dev), side="left")
  starts, ends = edges[:num_tiles], edges[1:]
  counts_t = ends - starts

  # chunk-level layout (K-sized)
  aligned_chunks = torch.clamp((counts_t + g - 1) // g, min=1)
  chunk_offsets = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                             torch.cumsum(aligned_chunks, 0)])
  k_chunks = p_cap // g + num_tiles
  chunk_ids = torch.arange(k_chunks, dtype=torch.int64, device=dev)
  first = chunk_offsets[:num_tiles]
  is_dummy = chunk_ids >= chunk_offsets[num_tiles]
  chunk_to_tile = torch.where(is_dummy, num_tiles,
                              _marker_fill(tile_ids, first, k_chunks))
  first_chunk = _marker_fill(first, first, k_chunks)
  chunk_src = (_marker_fill(starts, first, k_chunks)
               + (chunk_ids - first_chunk) * g)
  chunk_cnt = torch.clamp(_marker_fill(ends, first, k_chunks) - chunk_src,
                          0, g)
  chunk_cnt = torch.where(is_dummy, 0, chunk_cnt)
  chunk_src = torch.where(is_dummy, 0, torch.clamp(chunk_src, 0, p_cap))

  i32 = torch.int32
  return TileMapping(
      overlap_to_point=overlap_to_point,
      tile_ranges=torch.stack([starts, ends], -1).to(i32),
      sorted_payload=sorted_payload,
      chunk_to_tile=chunk_to_tile.to(i32),
      chunk_src=chunk_src.to(i32),
      chunk_cnt=chunk_cnt.to(i32),
      num_overflow=num_overflow,
      num_points=n,
      num_tiles=num_tiles,
      tiles_wide=tw,
      tiles_high=th,
      chunk_size=g,
      small_window=w_small,
      big_window=w_big,
      feature_size=f_size,
  )
