"""3D Morton (Z-order) codes and spatial point ordering (plain torch).

Counterpart of ``tpu_splatting/misc/morton.py``: bit-spreading Morton
codes over a bounded grid plus a sort-based spatial reordering.  The codes
are bit for bit the reference's: the grid coordinates keep its f32
operation order (``(p - lower) / max(upper - lower, 1e-12) * size``, then
clip, then truncate), the bits are spread in int64 (torch's uint32
support is thin) and the codes returned as int32.  ``argsort_morton`` is
one stable sort of the 60-bit key ``hi << 30 | lo``, the same permutation
as the reference's stable two-key ``lax.sort``, ties included; it returns
int64 indices (torch's index type).
"""

from __future__ import annotations

from typing import Tuple

import torch


def _spread_bits_10(x: torch.Tensor) -> torch.Tensor:
  """Spread the low 10 bits of x to every 3rd bit (int64)."""
  x = x.to(torch.int64) & 0x3FF
  x = (x | (x << 16)) & 0x30000FF
  x = (x | (x << 8)) & 0x300F00F
  x = (x | (x << 4)) & 0x30C30C3
  x = (x | (x << 2)) & 0x9249249
  return x


def _bounds(points, lower, upper):
  lower = points.amin(0) if lower is None else torch.as_tensor(
      lower, dtype=points.dtype, device=points.device)
  upper = points.amax(0) if upper is None else torch.as_tensor(
      upper, dtype=points.dtype, device=points.device)
  return lower, upper


def grid_coords(points: torch.Tensor, lower: torch.Tensor,
                upper: torch.Tensor, bits: int = 10) -> torch.Tensor:
  """Quantise points into a [0, 2^bits) integer grid (int64)."""
  size = (1 << bits) - 1
  scaled = (points - lower) / torch.clamp(upper - lower, min=1e-12) * size
  return torch.clamp(scaled, 0, size).to(torch.int64)


def morton_codes(points: torch.Tensor, lower: torch.Tensor = None,
                 upper: torch.Tensor = None) -> torch.Tensor:
  """30-bit Morton codes (int32) for (N, 3) points (bounds default to the
  data)."""
  lower, upper = _bounds(points, lower, upper)
  q = grid_coords(points, lower, upper, bits=10)
  code = (_spread_bits_10(q[:, 0])
          | (_spread_bits_10(q[:, 1]) << 1)
          | (_spread_bits_10(q[:, 2]) << 2))
  return code.to(torch.int32)


def morton_codes_60(points: torch.Tensor, lower=None, upper=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
  """60-bit codes as an (hi, lo) int32 pair for two-key sorting."""
  lower, upper = _bounds(points, lower, upper)
  q = grid_coords(points, lower, upper, bits=20)
  lo = (_spread_bits_10(q[:, 0] & 0x3FF)
        | (_spread_bits_10(q[:, 1] & 0x3FF) << 1)
        | (_spread_bits_10(q[:, 2] & 0x3FF) << 2))
  hi = (_spread_bits_10(q[:, 0] >> 10)
        | (_spread_bits_10(q[:, 1] >> 10) << 1)
        | (_spread_bits_10(q[:, 2] >> 10) << 2))
  return hi.to(torch.int32), lo.to(torch.int32)


def argsort_morton(points: torch.Tensor) -> torch.Tensor:
  """Spatial ordering permutation (int64): stable by (hi, lo)."""
  hi, lo = morton_codes_60(points)
  key = (hi.to(torch.int64) << 30) | lo.to(torch.int64)
  return torch.sort(key, stable=True).indices


def sort_by_morton(points: torch.Tensor, *arrays):
  """Reorder points (and companion arrays) into Morton order."""
  perm = argsort_morton(points)
  out = tuple(a[perm] for a in (points, *arrays))
  return out if len(out) > 1 else out[0]
