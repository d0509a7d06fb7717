"""Core data types: RasterConfig and Gaussian dataclasses of tensors.

Counterpart of ``tpu_splatting/data_types.py``.  ``RasterConfig`` keeps
every field and default of the reference, so one config dict describes a
render on either side (``convert.raster_config_from_dict``).  Fields that
only shaped the TPU kernels are accepted and ignored here:
``pixel_stride``, ``stream_passes``, ``stream_share_asm``,
``stream_asm_budget_mb`` and ``stream_gout_budget_mb`` (the backward is
one pass: see ``rasterizer/stream_function.py``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import torch


@dataclass(frozen=True, eq=True, kw_only=True)
class RasterConfig:
  """Rasterisation behaviour config (hashable; fields as the reference)."""
  tile_size: int = 16

  # clamp position to within this margin of the image for the affine Jacobian
  clamp_margin: float = 0.15

  # use the anti-aliased (pixel-integrated) pdf
  antialias: bool = False

  # blur covariance: diagonal added to the projected covariance
  blur_cov: float = 0.3

  clamp_max_alpha: float = 0.99
  alpha_threshold: float = 1.0 / 255.0

  # stop alpha blending once transmittance falls below 1 - this (a
  # "freeze", applied identically in forward and backward)
  saturate_threshold: float = 0.9999

  # if False, compute a quantile (e.g. median) instead of blending
  use_alpha_blending: bool = True

  compute_point_heuristic: bool = False  # implies compute_visibility
  compute_visibility: bool = False

  median_threshold: float = 0.25

  # overlap rows per chunk of the sorted pipeline
  chunk_size: int = 128

  # tile windows of the sorted-pipeline mapper; big_tile_window also
  # bounds the stream mapper's wide-splat duplication span
  tile_window: int = 3
  big_capacity: int = 8192
  big_tile_window: int = 16

  # ignored: register tiling knob of the reference backward
  pixel_stride: Tuple[int, int] = (2, 2)

  # "stream" | "sorted" | "auto" (see rasterizer/stream_function.py)
  pipeline: str = "auto"

  # static capacities of the stream pipeline (size them with
  # calibrate_stream); overflow is always counted in the mapping
  stream_num_slabs: int = 6
  stream_strip_cap: int = 8192
  stream_slab_cap: int = 512
  stream_group_width: int = 0   # 0 = widest of (8,4,2,1) dividing tiles_wide
  stream_w_max: int = 40
  stream_run_cap: int = 512
  stream_wide_cap: int = 1024
  stream_dup_cap: int = 8192

  # ignored: split-bf16 passes of the TPU rank-mask matmuls (the CUDA
  # kernel composites in f32)
  stream_passes: int = 2

  # ignored: TPU forward/backward sharing of assembled slab blocks
  stream_share_asm: bool = True
  stream_asm_budget_mb: int = 2048

  # HBM budget (MB) of the backward's gradient-slab buffers
  stream_gout_budget_mb: int = 4096

  @property
  def tile_area(self) -> int:
    return self.tile_size * self.tile_size


@dataclass
class Gaussians3D:
  """3D Gaussian mixture.

  Fields (N leading batch dim):
    position:    (N, 3) xyz
    log_scaling: (N, 3) scale = exp(log_scaling)
    rotation:    (N, 4) quaternion, xyzw layout (scalar last)
    alpha_logit: (N, 1) alpha = sigmoid(alpha_logit)
    feature:     (N, C) or (N, 3, (d+1)**2) SH coefficients
  """
  position: torch.Tensor
  log_scaling: torch.Tensor
  rotation: torch.Tensor
  alpha_logit: torch.Tensor
  feature: torch.Tensor

  def __len__(self):
    return self.position.shape[0]

  def shape_tensors(self):
    return (self.position, self.log_scaling, self.rotation, self.alpha_logit)

  def replace(self, **kw) -> "Gaussians3D":
    return dataclasses.replace(self, **kw)


@dataclass
class Gaussians2D:
  """2D Gaussian mixture.

  Fields (N leading batch dim):
    position:    (N, 2) xy
    depths:      (N,) or (N, 1) depth for sorting
    log_scaling: (N, 2)
    rotation:    (N, 2) unit-length 2-vector (major axis direction)
    alpha_logit: (N, 1)
    feature:     (N, C)
  """
  position: torch.Tensor
  depths: torch.Tensor
  log_scaling: torch.Tensor
  rotation: torch.Tensor
  alpha_logit: torch.Tensor
  feature: torch.Tensor

  def __len__(self):
    return self.position.shape[0]

  def replace(self, **kw) -> "Gaussians2D":
    return dataclasses.replace(self, **kw)
