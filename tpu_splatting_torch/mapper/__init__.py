from .tile_mapper import pad_to_tile, tile_shape

__all__ = ["pad_to_tile", "tile_shape"]
