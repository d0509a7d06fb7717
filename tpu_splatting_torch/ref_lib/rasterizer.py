"""Rasterization oracle (re-export).

The sequential per-pixel compositing oracle lives next to the kernels it
validates (``rasterizer/reference.py``); re-exported here so the whole
ground-truth layer is one package, as in the reference.
"""

from ..rasterizer.reference import rasterize_reference

__all__ = ["rasterize_reference"]
