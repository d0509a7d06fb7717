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
import math
from dataclasses import dataclass
from typing import Tuple

import torch

from .lib import transforms


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

  @property
  def batch_size(self):
    return (self.position.shape[0],)

  def packed(self) -> torch.Tensor:
    """(N, 11): position, log_scaling, rotation, alpha_logit."""
    return torch.cat(
        [self.position, self.log_scaling, self.rotation, self.alpha_logit], -1)

  @staticmethod
  def from_packed(packed: torch.Tensor,
                  feature: torch.Tensor) -> "Gaussians3D":
    return Gaussians3D(
        position=packed[:, 0:3], log_scaling=packed[:, 3:6],
        rotation=packed[:, 6:10], alpha_logit=packed[:, 10:11],
        feature=feature)

  def shape_tensors(self):
    return (self.position, self.log_scaling, self.rotation, self.alpha_logit)

  @property
  def scale(self):
    return torch.exp(self.log_scaling)

  @property
  def alpha(self):
    return transforms.sigmoid(self.alpha_logit)

  def scaled(self, scale: float) -> "Gaussians3D":
    return dataclasses.replace(
        self, position=self.position * scale,
        log_scaling=self.log_scaling + math.log(scale))

  def translated(self, translation: torch.Tensor) -> "Gaussians3D":
    return dataclasses.replace(
        self, position=self.position + translation.reshape(1, 3))

  def transform_rigid(self, m44: torch.Tensor) -> "Gaussians3D":
    """Rigid transform of positions and orientations: q' = q_m * q, with
    q_m the quaternion of m44's rotation."""
    position = transforms.transform_points(m44, self.position)
    r, _ = transforms.split_rt(m44)
    q_m = mat_to_quat(r)
    rotation = transforms.quat_mul(q_m.expand_as(self.rotation),
                                   self.rotation)
    return dataclasses.replace(self, position=position, rotation=rotation)

  def replace(self, **kw) -> "Gaussians3D":
    return dataclasses.replace(self, **kw)

  @staticmethod
  def concat(gaussians) -> "Gaussians3D":
    """Each field of the list's mixtures concatenated along dim 0."""
    return Gaussians3D(**{
        f.name: torch.cat([getattr(g, f.name) for g in gaussians], 0)
        for f in dataclasses.fields(Gaussians3D)})


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

  @property
  def batch_size(self):
    return (self.position.shape[0],)

  @property
  def opacity(self):
    return transforms.sigmoid(self.alpha_logit)

  @property
  def scaling(self):
    return torch.exp(self.log_scaling)

  def set_scaling(self, scaling) -> "Gaussians2D":
    return dataclasses.replace(self, log_scaling=torch.log(scaling))

  def replace(self, **kw) -> "Gaussians2D":
    return dataclasses.replace(self, **kw)


def mat_to_quat(r: torch.Tensor) -> torch.Tensor:
  """Rotation matrix (3, 3) -> quaternion xyzw (branch-free Shepperd: four
  candidates, the one of the largest pivot of (trace, m00, m11, m22)
  taken, the first of tied maxima, then normalised)."""
  m00, m01, m02 = r[0, 0], r[0, 1], r[0, 2]
  m10, m11, m12 = r[1, 0], r[1, 1], r[1, 2]
  m20, m21, m22 = r[2, 0], r[2, 1], r[2, 2]
  tr = m00 + m11 + m22

  def q_from(t, a, b, c, d):
    s = torch.sqrt(torch.clamp(t, min=1e-12)) * 2.0
    return torch.stack([a / s, b / s, c / s, d / s])

  qw = q_from(1.0 + tr, m21 - m12, m02 - m20, m10 - m01, 1.0 + tr)
  qx = q_from(1.0 + m00 - m11 - m22, 1.0 + m00 - m11 - m22, m01 + m10,
              m02 + m20, m21 - m12)
  qy = q_from(1.0 - m00 + m11 - m22, m01 + m10, 1.0 - m00 + m11 - m22,
              m12 + m21, m02 - m20)
  qz = q_from(1.0 - m00 - m11 + m22, m02 + m20, m12 + m21,
              1.0 - m00 - m11 + m22, m10 - m01)

  idx = torch.argmax(torch.stack([tr, m00, m11, m22]))
  q = torch.stack([qw, qx, qy, qz])[idx]
  return transforms.normalize(q)
