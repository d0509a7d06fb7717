from ..data_types import RasterConfig
from .function import RasterOut, rasterize, rasterize_with_tiles

__all__ = ["RasterConfig", "RasterOut", "rasterize", "rasterize_with_tiles"]
