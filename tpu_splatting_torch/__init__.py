"""tpu_splatting_torch — the PyTorch + CUDA port of tpu_splatting.

The JAX package ``tpu_splatting`` is the reference; this package grows
beside it, module for module (``tpu_splatting_torch/rasterizer/stream.py``
is the counterpart of ``tpu_splatting/rasterizer/stream.py``), and holds
the same public names for the parts ported so far: the render and
training path through the tile-stream and the sorted-overlap pipelines
(``render_gaussians``, ``render_with_heuristics``, ``map_to_tiles``,
``rasterize``, ``rasterize_with_tiles``), the fractional optimizers
(``tpu_splatting_torch.optim``) and the multi-device paths
(``tpu_splatting_torch.parallel``: camera-batch data parallelism,
point-sharded projection, band-sharded stream rasterization, over a
single-process mesh of devices), a subpackage as in the reference.
Plain code is torch; the TPU's
Pallas kernels become hand-written CUDA kernels for Hopper (``csrc/``),
built at first use.  The package imports torch and numpy only.
"""

from . import perspective
from .data_types import Gaussians2D, Gaussians3D, RasterConfig
from .mapper.tile_mapper import TileMapping, map_to_tiles, pad_to_tile
from .perspective import CameraParams
from .rasterizer.function import RasterOut, rasterize, rasterize_with_tiles
from .rasterizer.stream import StreamMapping, calibrate_stream, stream_map
from .rasterizer.stream_function import stream_rasterize_with_mapping
from .renderer import (render_gaussians, render_projected,
                       render_with_heuristics, viewspace_gradient)
from .rendering import RenderedPoints, Rendering
from .spherical_harmonics import evaluate_sh_at

__all__ = [
    "Gaussians2D", "Gaussians3D", "RasterConfig", "CameraParams",
    "TileMapping", "map_to_tiles", "pad_to_tile",
    "RasterOut", "rasterize", "rasterize_with_tiles",
    "StreamMapping", "calibrate_stream", "stream_map",
    "stream_rasterize_with_mapping",
    "render_gaussians", "render_projected", "render_with_heuristics",
    "viewspace_gradient", "RenderedPoints", "Rendering", "evaluate_sh_at",
    "perspective",
]
