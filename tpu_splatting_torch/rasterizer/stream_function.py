"""Rasterization over the tile-stream pipeline (forward).

Counterpart of ``tpu_splatting/rasterizer/stream_function.py``.  The
rasterize op is a ``torch.autograd.Function`` whose forward is
``stream_forward``; its backward (the stream backward kernels and the
gradient reduce) is ROADMAP item P6 and raises until then, so that
differentiating through it fails loudly instead of returning zeros.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..data_types import RasterConfig
from ..mapper.tile_mapper import tile_shape
from .stream import StreamMapping, stream_map
from .stream_kernels import stream_forward


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


class _StreamRaster(torch.autograd.Function):
  """image_tiled = stream_forward(mapping); the mapping's table is a copy
  of (gaussians2d, features), which carry the gradient."""

  @staticmethod
  def forward(ctx, gaussians2d, features, probe, mapping, config):
    return stream_forward(mapping, config)

  @staticmethod
  def backward(ctx, g_image_tiled):
    raise NotImplementedError("stream backward: ROADMAP P6")


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
