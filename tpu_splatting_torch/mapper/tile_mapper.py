"""Tile-grid helpers shared by the mappers.

Only ``pad_to_tile`` and ``tile_shape`` of ``tpu_splatting/mapper/
tile_mapper.py`` are ported so far; the sorted-overlap mapper
(``map_to_tiles``) is ROADMAP item P9.
"""

from __future__ import annotations

import math
from typing import Tuple


def pad_to_tile(image_size: Tuple[int, int], tile_size: int):
  """Round an image size up to a tile multiple."""
  return tuple(int(math.ceil(x / tile_size) * tile_size) for x in image_size)


def tile_shape(image_size: Tuple[int, int], tile_size: int) -> Tuple[int, int]:
  """(tiles_wide, tiles_high) for an image size."""
  w, h = pad_to_tile(image_size, tile_size)
  return w // tile_size, h // tile_size
