"""Scene IO (``tpu_splatting/io`` counterpart): 3DGS checkpoint PLY files
to and from ``Gaussians3D``."""

from .ply import load_gaussians, read_ply_raw, save_gaussians, write_ply_raw

__all__ = ["load_gaussians", "save_gaussians", "read_ply_raw",
           "write_ply_raw"]
