"""Differentiable rasterization over the sorted-overlap pipeline.

Counterpart of ``tpu_splatting/rasterizer/function.py``.  The rasterize
op is a ``torch.autograd.Function``: its forward is ``kernels.forward``
(K4, with per-overlap visibility when asked); its backward is
``kernels.backward`` (K5), then ``segment_sum_sorted`` (K7), which
gathers the per-overlap gradient rows by point id and reduces them to
per-point gradients.  The order it gathers by (the chunk slots' point
ids by ``window_copy``, K6, sorted stably) is computed at most once per
``rasterize_with_tiles`` call: the visibility reduce and the backward
share it.

The point heuristics (prune_cost, split_score) are the cotangent of a
zero-valued ``heuristic_probe`` input, as in the reference; visibility
is a forward product here.  Quantile (non-blending) mode is forward-only:
its output carries no gradient.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ..data_types import RasterConfig
from ..mapper.tile_mapper import TileMapping, map_to_tiles, tile_shape
from . import kernels
from .layout import segment_sum_sorted, window_copy
from .stream_function import (detile, probe_width, stream_eligible,
                              stream_map_with_config,
                              stream_rasterize_with_mapping)


class RasterOut(NamedTuple):
  """The reference's RasterOut."""
  image: torch.Tensor                      # (H, W, F)
  image_weight: torch.Tensor               # (H, W)
  point_heuristic: Optional[torch.Tensor]  # (N, 2), via the probe gradient
  visibility: Optional[torch.Tensor]       # (N,)
  # () i32 rows dropped by the static capacities when the op built its own
  # mapping
  num_overflow: Optional[torch.Tensor] = None


def _kernel_inputs(mapping: TileMapping, gaussians2d, features):
  """(sorted_rows, chunk_src, chunk_cnt) for the raster kernels.

  The mapper's sorted payload feeds the kernels directly when it carries
  these features.  Otherwise (a mapping built without features, or with
  another feature width, as in the median-depth pass) the rows are
  gathered into a chunk-aligned buffer read through identity windows."""
  g = mapping.chunk_size
  if (mapping.sorted_payload is not None
      and mapping.feature_size == features.shape[1]):
    return mapping.sorted_payload, mapping.chunk_src, mapping.chunk_cnt
  rows = torch.cat([gaussians2d, features.to(gaussians2d.dtype)], -1)
  rows_ext = torch.cat([rows, rows.new_zeros((1, rows.shape[1]))])
  chunked = torch.cat([rows_ext[mapping.point_id_chunked.long()],
                       rows.new_zeros((g, rows.shape[1]))])
  src = torch.arange(mapping.num_chunks, dtype=torch.int32,
                     device=rows.device) * g
  return chunked, src, mapping.chunk_cnt


def _pid_chunked(mapping: TileMapping) -> torch.Tensor:
  """(K*g,) i32 point id per chunk slot (null = num_points), by the
  window-copy kernel.  The port copies int32 ids as they are (the
  reference carries them by value in f32)."""
  copied = window_copy(mapping.overlap_to_point, mapping.chunk_src,
                       mapping.chunk_cnt, mapping.chunk_size)
  # window_copy zero-fills invalid slots, and 0 is a real point id
  r = torch.arange(mapping.chunk_size, device=copied.device)
  valid = (r < mapping.chunk_cnt[:, None]).reshape(-1)
  return torch.where(valid, copied, mapping.num_points)


class PointOrder(NamedTuple):
  """The chunk slots' point ids sorted stably, and the permutation."""
  ids: torch.Tensor     # (A,) i32 ascending; null slots (num_points) last
  order: torch.Tensor   # (A,) i64: sorted position i is slot order[i]


# sorts of point ids by sort_point_ids (each reduce's torch.sort)
sort_counts = {"point_ids": 0}


def sort_point_ids(pid: torch.Tensor) -> PointOrder:
  """``torch.sort(pid, stable=True)``, counted in ``sort_counts``."""
  sort_counts["point_ids"] += 1
  return PointOrder(*torch.sort(pid, stable=True))


def lazy_point_order(mapping: TileMapping):
  """A callable that sorts the mapping's point ids at its first call and
  returns that ``PointOrder`` at every call."""
  return functools.cache(lambda: sort_point_ids(_pid_chunked(mapping)))


def reduce_chunked_to_points(x_chunked: torch.Tensor, by_point: PointOrder,
                             num_points: int) -> torch.Tensor:
  """Sum per-chunk-slot rows (A, C) into per-point rows (N, C).

  ``by_point`` is the slots' point ids sorted by ``sort_point_ids``.  The
  rows are read in that order inside the segment-sum kernel: no sorted
  copy is written."""
  return segment_sum_sorted(x_chunked, by_point.ids, num_points,
                            order=by_point.order)


class _SortedRaster(torch.autograd.Function):
  """(image_tiled, vis_chunked) = forward(rows of (gaussians2d, features));
  the heuristic probe's gradient carries (prune_cost, split_score)."""

  @staticmethod
  def forward(ctx, gaussians2d, features, probe, mapping, config, num_tiles,
              tiles_wide, with_vis, point_order):
    rows, src, cnt = _kernel_inputs(mapping, gaussians2d.detach(),
                                    features.detach())
    image_tiled, vis_chunked = kernels.forward(
        rows, src, cnt, mapping.chunk_to_tile, config, num_tiles, tiles_wide,
        with_vis=with_vis)
    ctx.mapping, ctx.config = mapping, config
    ctx.num_tiles, ctx.tiles_wide = num_tiles, tiles_wide
    ctx.point_order = point_order
    ctx.f = features.shape[1]
    ctx.save_for_backward(rows, src, cnt, image_tiled)
    if vis_chunked is None:
      return image_tiled
    ctx.mark_non_differentiable(vis_chunked)
    return image_tiled, vis_chunked

  @staticmethod
  def backward(ctx, g_image_tiled, *_g_vis):
    rows, src, cnt, image_tiled = ctx.saved_tensors
    mapping, config, f = ctx.mapping, ctx.config, ctx.f
    n = mapping.num_points
    gout = kernels.backward(
        rows, image_tiled, g_image_tiled.contiguous(), src, cnt,
        mapping.chunk_to_tile, config, ctx.num_tiles, ctx.tiles_wide)
    reduced = reduce_chunked_to_points(gout, ctx.point_order(), n)
    # free the order after its last use (a second backward sorts again)
    ctx.point_order = lazy_point_order(mapping)
    heur = (reduced[:, 7 + f:9 + f] if config.compute_point_heuristic
            else reduced.new_zeros((n, 2)))
    return (reduced[:, :7], reduced[:, 7:7 + f], heur, None, None, None,
            None, None, None)


def rasterize_with_tiles(
    gaussians2d: torch.Tensor,    # (N, 7)
    features: torch.Tensor,       # (N, F)
    mapping: TileMapping,
    image_size: Tuple[int, int],
    config: RasterConfig,
    heuristic_probe: Optional[torch.Tensor] = None,   # (N, 2)
) -> RasterOut:
  """Rasterize with a precomputed tile mapping.

  If the mapping was built with these features, its sorted payload feeds
  the kernels; otherwise the rows are gathered from the arguments.
  Callers pass the tensors the mapping was built from.
  ``heuristic_probe`` is an all-zeros (N, 2) tensor whose gradient under
  any loss is (prune_cost, split_score)."""
  n, f = features.shape
  assert gaussians2d.shape == (n, 7), gaussians2d.shape
  tw, th = tile_shape(image_size, config.tile_size)
  num_tiles = tw * th
  with_vis = config.compute_visibility or config.compute_point_heuristic
  # sorted at the first reduce that needs it, shared by the other
  point_order = lazy_point_order(mapping)

  if not config.use_alpha_blending:
    rows, src, cnt = _kernel_inputs(mapping, gaussians2d.detach(),
                                    features.detach())
    image_tiled, vis_chunked = kernels.forward(
        rows, src, cnt, mapping.chunk_to_tile, config, num_tiles, tw,
        with_vis=with_vis)
  else:
    if heuristic_probe is None:
      heuristic_probe = gaussians2d.new_zeros((n, 2))
    out = _SortedRaster.apply(gaussians2d, features, heuristic_probe,
                              mapping, config, num_tiles, tw, with_vis,
                              point_order)
    image_tiled, vis_chunked = out if with_vis else (out, None)

  # (T+1, F+1, PIX) -> (H, W, F+1); row T is the dummy tile
  full = detile(image_tiled[:num_tiles], tw, th, config.tile_size,
                image_size)
  visibility = None
  if with_vis:
    visibility = reduce_chunked_to_points(vis_chunked.detach(),
                                          point_order(), n)[:, 0]
  return RasterOut(image=full[..., :f], image_weight=full[..., f],
                   point_heuristic=None, visibility=visibility)


def rasterize(gaussians2d: torch.Tensor, depth: torch.Tensor,
              features: torch.Tensor, image_size: Tuple[int, int],
              config: RasterConfig, use_depth16: bool = False,
              max_overlaps: Optional[int] = None,
              heuristic_probe: Optional[torch.Tensor] = None,
              probe: Optional[torch.Tensor] = None) -> RasterOut:
  """Map to tiles + rasterize.

  Goes through the tile-stream pipeline when ``config.pipeline`` allows,
  else the sorted-overlap pipeline.  On the stream path the per-point
  outputs are backward products: ``visibility`` is None (thread a full
  ``probe`` of width ``probe_width(config)`` and read its gradient);
  ``heuristic_probe``'s gradient carries (prune_cost, split_score) on both
  pipelines."""
  assert gaussians2d.shape[0] == depth.shape[0] == features.shape[0]
  if stream_eligible(config, image_size):
    n = gaussians2d.shape[0]
    mapping = stream_map_with_config(
        gaussians2d.detach(), depth.detach(), features.detach(), image_size,
        config)
    pw = probe_width(config)
    if probe is None and heuristic_probe is not None and pw >= 2:
      # the caller's (N, 2) probe gets (prune, split) through the concat
      probe = torch.cat([gaussians2d.new_zeros((n, pw - 2)),
                         heuristic_probe], -1)
    image, image_weight = stream_rasterize_with_mapping(
        gaussians2d, features, mapping, image_size, config, probe=probe)
    return RasterOut(image=image, image_weight=image_weight,
                     point_heuristic=None, visibility=None,
                     num_overflow=mapping.num_overflow)

  mapping = map_to_tiles(
      gaussians2d.detach(), depth.detach(), image_size=image_size,
      config=config, max_overlaps=max_overlaps, use_depth16=use_depth16,
      features=features.detach())
  return rasterize_with_tiles(
      gaussians2d, features, mapping, image_size=image_size, config=config,
      heuristic_probe=heuristic_probe)._replace(
          num_overflow=mapping.num_overflow)
