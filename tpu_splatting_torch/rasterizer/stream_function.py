"""Differentiable rasterization over the tile-stream pipeline.

Counterpart of ``tpu_splatting/rasterizer/stream_function.py``.  The
rasterize op is a ``torch.autograd.Function``: its forward is
``stream_forward`` (K1); its backward is ``backward_reduce``, which runs
``stream_backward`` (K2, with the reference's slab merge K3 fused in) into
the home-major gradient buffer and gathers that buffer back to the
caller's point order (``reduce_stage2``).

Visibility and the point heuristics are the cotangent of a zero-valued
probe input, as in the reference: they cost no pass beyond the backward
every training step runs anyway.  Quantile mode is forward-only.

The reference bounds its nine per-class gradient-slab buffers with a
band-chunked backward (``stream_gout_budget_mb``).  The one home-major
buffer here is about 164 MB at the 2M-splat headline capacities (run_cap
256) and 2.6 GB at heavy-scene ones (run_cap 4096), where the slab
buffers take 2.2 GB and more, so the backward is a single pass and the
knob is accepted and ignored.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import trace
from ..data_types import RasterConfig
from ..mapper.tile_mapper import tile_shape
from .stream import StreamMapping, stream_map
from .stream_kernels import stream_backward, stream_forward


def detile(image_tiled: torch.Tensor, tiles_wide: int, tiles_high: int,
           tile_size: int, image_size: Tuple[int, int]) -> torch.Tensor:
  """(T, C, tile_area) -> (H, W, C)."""
  w_img, h_img = image_size
  c = image_tiled.shape[1]
  t = image_tiled.reshape(tiles_high, tiles_wide, c, tile_size, tile_size)
  full = t.permute(0, 3, 1, 4, 2).reshape(
      tiles_high * tile_size, tiles_wide * tile_size, c)
  return full[:h_img, :w_img]


def entile(image: torch.Tensor, tiles_wide: int, tiles_high: int,
           tile_size: int) -> torch.Tensor:
  """(H, W, C) -> (T, C, tile_area), zero-padding to tile multiples."""
  h, w, c = image.shape
  ph = tiles_high * tile_size - h
  pw = tiles_wide * tile_size - w
  img = torch.nn.functional.pad(image, (0, 0, 0, pw, 0, ph))
  t = img.reshape(tiles_high, tile_size, tiles_wide, tile_size, c)
  return t.permute(0, 2, 4, 1, 3).reshape(
      tiles_high * tiles_wide, c, tile_size * tile_size)


def tile_mask(image_size: Tuple[int, int], tiles_wide: int, tiles_high: int,
              tile_size: int, device=None) -> torch.Tensor:
  """(T, 1, PIX) f32 mask of the pixels inside the image."""
  w, h = image_size
  ones = torch.ones((h, w, 1), dtype=torch.float32, device=device)
  return entile(ones, tiles_wide, tiles_high, tile_size)


def probe_width(config: RasterConfig) -> int:
  """Columns of the probe cotangent: [visibility][, prune, split]."""
  heur = config.compute_point_heuristic
  with_vis = heur or config.compute_visibility
  return (1 if with_vis else 0) + (2 if heur else 0)


def auto_group_width(tiles_wide: int, config: RasterConfig) -> int:
  """The config's group width, or the widest of (8, 4, 2, 1) dividing
  tiles_wide."""
  gw = config.stream_group_width
  if gw:
    assert tiles_wide % gw == 0, (tiles_wide, gw)
    return gw
  for g in (8, 4, 2, 1):
    if tiles_wide % g == 0:
      return g
  raise AssertionError


def stream_eligible(config: RasterConfig, image_size) -> bool:
  """Whether the stream pipeline can serve this render (16-bit home-tile
  ids: at most 65,535 tiles); ``pipeline="stream"`` asserts instead."""
  if config.pipeline == "sorted":
    return False
  tw, th = tile_shape(image_size, config.tile_size)
  ok = tw * th < (1 << 16)
  if config.pipeline == "stream":
    assert ok, (f"stream pipeline cannot address {tw * th} tiles "
                f"(16-bit home id); raise tile_size or use sorted")
    return True
  return ok


def stream_map_with_config(gaussians2d, depth, features, image_size,
                           config: RasterConfig) -> StreamMapping:
  """stream_map with capacities taken from the RasterConfig knobs."""
  tw, _ = tile_shape(image_size, config.tile_size)
  return stream_map(
      gaussians2d, depth, features, image_size, config,
      num_slabs=config.stream_num_slabs,
      strip_cap=config.stream_strip_cap,
      slab_cap=config.stream_slab_cap,
      group_width=auto_group_width(tw, config),
      w_max=config.stream_w_max,
      run_cap=config.stream_run_cap,
      wide_cap=config.stream_wide_cap,
      dup_cap=config.stream_dup_cap)


def reduce_stage2(buf: torch.Tensor, mapping: StreamMapping) -> torch.Tensor:
  """Stage 2 of the gradient reduce: the home-major (R + 1, slabw) buffer
  -> (N, slabw) per-point gradients in the caller's point order.

  The reference's gather path: one row gather at the map-time
  ``grad_src`` indices, then each duplicate row's gradient added to its
  point (unused duplicate slots carry ``dup_pid == N`` and land in a
  scratch row).  The reference's sort path computes the same columns."""
  n = mapping.num_points
  v = buf[mapping.grad_src.long()]
  if mapping.dup_cap > 0:
    v = torch.cat([v, v.new_zeros((1, v.shape[1]))])
    v.index_add_(0, mapping.dup_pid.long(), buf[mapping.dup_src.long()])
    v = v[:n]
  return v


def stream_reduce(buf: torch.Tensor, mapping: StreamMapping) -> torch.Tensor:
  """The reference's ``stream_reduce`` (slab merge + stage 2): the merge
  is fused into ``stream_backward``, so only stage 2 is left."""
  return reduce_stage2(buf, mapping)


def backward_reduce(mapping: StreamMapping, image_tiled: torch.Tensor,
                    g_image_tiled: torch.Tensor,
                    config: RasterConfig) -> torch.Tensor:
  """Backward kernel + reduce in one pass: (N, slabw) per-point columns
  [7 packed-gaussian grads, F feature grads, probe columns]."""
  buf = stream_backward(mapping, image_tiled, g_image_tiled, config)
  return reduce_stage2(buf, mapping)


class _StreamRaster(torch.autograd.Function):
  """image_tiled = stream_forward(mapping); the mapping's table is a copy
  of (gaussians2d, features), which carry the gradient, and the probe's
  gradient carries [visibility][, prune_cost, split_score]."""

  @staticmethod
  def forward(ctx, gaussians2d, features, probe, mapping, config):
    image_tiled = stream_forward(mapping, config)
    ctx.mapping, ctx.config = mapping, config
    ctx.save_for_backward(image_tiled)
    return image_tiled

  @staticmethod
  def backward(ctx, g_image_tiled):
    (image_tiled,) = ctx.saved_tensors
    mapping, config = ctx.mapping, ctx.config
    f = mapping.feature_size
    with trace.span("backward.raster"):
      g = backward_reduce(mapping, image_tiled, g_image_tiled, config)
    return g[:, :7], g[:, 7:7 + f], g[:, 7 + f:], None, None


def stream_rasterize_with_mapping(
    gaussians2d: torch.Tensor, features: torch.Tensor,
    mapping: StreamMapping, image_size: Tuple[int, int],
    config: RasterConfig, run_cap: int = 0,
    probe: Optional[torch.Tensor] = None, tiled: bool = False):
  """Rasterize with a precomputed stream mapping.

  Returns (image (H, W, F), image_weight (H, W)), or the (T, F+1, PIX)
  tiled image when ``tiled``.  Quantile mode (use_alpha_blending=False)
  is forward-only: its output carries no gradient."""
  assert run_cap in (0, mapping.run_cap), (run_cap, mapping.run_cap)
  f = features.shape[1]
  if not config.use_alpha_blending:
    image_tiled = stream_forward(mapping, config).detach()
  else:
    if probe is None:
      probe = torch.zeros((mapping.num_points, probe_width(config)),
                          dtype=gaussians2d.dtype, device=gaussians2d.device)
    image_tiled = _StreamRaster.apply(gaussians2d, features, probe, mapping,
                                      config)
  if tiled:
    return image_tiled
  full = detile(image_tiled, mapping.tiles_wide, mapping.tiles_high,
                config.tile_size, image_size)
  return full[..., :f], full[..., f]
