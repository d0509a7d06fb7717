"""The yardstick's arithmetic: peaks, operations and bytes per kernel and
per step, roofline shares.

Operations count one per f32 add, multiply, compare or transcendental, per
(splat row, pixel) pair in blending mode with F features:

* K1 (the forward compositor): alpha (a 6-term quadratic form and exp)
  11, threshold and clamp 2, exp(lt) 1, weight 1, features 2F, weight sum
  1, log1p and add 2: 18 + 2F.
* K2 (the backward compositor, pixel-moment form): K1's count with alpha
  from u, v (u, v 8, u^2 + v^2 3, scale, exp and alpha 3: 14 in place of
  11), then the gradient chain: g.f 2F + 1, remaining sum 4, alpha
  gradient 4, z0 2, z0 u and z0 v 2, four moment products 4, features F,
  prune 1, split 9, and the pixel reduction of its output columns (7 + F
  + 3 with visibility and heuristics).

Pairs are (splat, tile) pairs of the harness's own listing
(``reference.raster.count_pairs``) times the tile's 256 pixels, so the
work counted is the same whatever the program lists.  Per splat, the
projection forward is counted at 150 operations and SH degree 3 at 130
(basis 40, contraction 2 x 48, clamp), each backward at twice its
forward.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: f32 outside the tensor cores; HBM3
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
PIXELS = 256                     # a 16 x 16 tile
PROJECT_OPS, SH_OPS = 150, 130


def k1_ops_per_pair(f: int) -> int:
  return 18 + 2 * f


def k2_ops_per_pair(f: int, heuristics: bool = True) -> int:
  cols = 7 + f + (3 if heuristics else 0)
  return (k1_ops_per_pair(f) - 11 + 14 + (2 * f + 1) + 4 + 4 + 2 + 2 + 4
          + f + (1 + 9 if heuristics else 0) + cols)


def k1_bytes(pairs: int, tiles: int, f: int) -> int:
  """Each listed row (7 + F + 1 floats) read once, the tiled image (F + 1
  channels) written once."""
  return 4 * (pairs * (8 + f) + tiles * (f + 1) * PIXELS)


def k2_bytes(pairs: int, tiles: int, f: int, heuristics: bool = True) -> int:
  """Rows read, each row's gradient columns written, the image and its
  cotangent read."""
  cols = 7 + f + (3 if heuristics else 0)
  return 4 * (pairs * (8 + f + cols) + 2 * tiles * (f + 1) * PIXELS)


def least_seconds(ops: float, nbytes: float) -> float:
  """The larger of operations over the f32 peak and bytes over the memory
  rate."""
  return max(ops / PEAK_F32_OPS, nbytes / PEAK_BYTES)


def share(least_s: float, measured_s: float):
  """least / measured in %, or None without a measurement."""
  if not measured_s or measured_s <= 0:
    return None
  return 100.0 * least_s / measured_s


def step_ops(pairs: int, f: int, splats: int, train: bool, projected: bool,
             sh: bool) -> float:
  """Operations of one render (``train``: forward + backward): the
  compositors' per pair and the front end's per splat."""
  per_pair = k1_ops_per_pair(f) + (k2_ops_per_pair(f) if train else 0)
  front = (PROJECT_OPS if projected else 0) + (SH_OPS if sh else 0)
  return pairs * PIXELS * per_pair + splats * front * (3 if train else 1)
