"""Sequential per-pixel rasterization oracle (numpy, test ground truth).

The port's own copy of ``tpu_splatting/rasterizer/reference.py``: a
deliberately naive loop over tiles, pixels and each tile's overlaps with
exactly the semantics the sorted-pipeline kernels vectorise: front-to-back
alpha compositing with threshold masking, alpha clamping and the
transmittance freeze, the quantile (non-blending) mode and per-point
visibility.  O(tiles * points * pixels); tiny scenes only.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..data_types import RasterConfig
from ..mapper.tile_mapper import TileMapping, tile_shape


def _pdf(px, py, g, antialias):
  mean_x, mean_y, ax, ay, sx, sy, _ = g
  dx, dy = px - mean_x, py - mean_y
  tu = dx * ax + dy * ay
  tv = -dx * ay + dy * ax
  if not antialias:
    return np.exp(-0.5 * ((tu / sx) ** 2 + (tv / sy) ** 2))

  def s_sig(x, s):
    z = x / s
    return 1.0 / (1.0 + np.exp(-1.6 * z - 0.07 * z ** 3))

  ix = sx * (s_sig(tu + 0.5, sx) - s_sig(tu - 0.5, sx))
  iy = sy * (s_sig(tv + 0.5, sy) - s_sig(tv - 0.5, sy))
  return 2.0 * np.pi * ix * iy


def _numpy(x):
  return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def rasterize_reference(gaussians2d, features, mapping: TileMapping,
                        image_size: Tuple[int, int], config: RasterConfig):
  """Returns (image (H,W,F), image_alpha (H,W), visibility (N,))."""
  gaussians2d = _numpy(gaussians2d).astype(np.float64)
  features = _numpy(features).astype(np.float64)
  o2p = _numpy(mapping.overlap_to_point)
  ranges = _numpy(mapping.tile_ranges)

  w_img, h_img = image_size
  n, f = features.shape
  ts = config.tile_size
  tw, th = tile_shape(image_size, ts)

  image = np.zeros((th * ts, tw * ts, f))
  alpha_img = np.zeros((th * ts, tw * ts))
  visibility = np.zeros(n)
  cut = 1.0 - config.saturate_threshold

  for tile in range(tw * th):
    tx, ty = tile % tw, tile // tw
    s, e = ranges[tile]
    point_ids = o2p[s:e]

    for py_i in range(ts):
      for px_i in range(ts):
        px = tx * ts + px_i + 0.5
        py = ty * ts + py_i + 0.5

        t_run = 1.0
        accum = np.zeros(f)
        total_weight = 0.0
        crossed = False

        for pid in point_ids:
          g = gaussians2d[pid]
          a = g[6] * _pdf(px, py, g, config.antialias)
          a = min(a, config.clamp_max_alpha)
          if a <= config.alpha_threshold:
            continue

          if config.use_alpha_blending:
            if t_run <= cut:           # transmittance freeze
              continue
            w = a * t_run
            accum += features[pid] * w
            total_weight += w
            visibility[pid] += w
            t_run *= (1.0 - a)
          else:
            # quantile mode: no freeze; the feature at the first crossing
            w = a * t_run
            visibility[pid] += w
            t_run_new = t_run * (1.0 - a)
            if (t_run_new <= config.saturate_threshold
                and t_run > config.saturate_threshold and not crossed):
              accum = features[pid].copy()
              crossed = True
            t_run = t_run_new

        image[ty * ts + py_i, tx * ts + px_i] = accum
        if config.use_alpha_blending:
          alpha_img[ty * ts + py_i, tx * ts + px_i] = total_weight
        else:
          alpha_img[ty * ts + py_i, tx * ts + px_i] = float(t_run < 1.0)

  return image[:h_img, :w_img], alpha_img[:h_img, :w_img], visibility
