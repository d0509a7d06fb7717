"""Benchmark scenes as port inputs (numpy + torch only).

``lift_to_3d`` is the counterpart of ``bench.lift_to_3d``, which builds
JAX arrays; the 2D scene generators ``uniform_scene`` and ``heavy_scene``
are plain numpy and are imported from ``bench`` by callers.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .data_types import Gaussians3D
from .perspective.params import CameraParams


def lift_to_3d(packed, depth_ndc, feats, image_size, near, far, fov_deg,
               device=None):
  """Lift a 2D bench scene to Gaussians3D + CameraParams whose projection
  reproduces (approximately) the same screen-space statistics: each splat
  sits on the camera ray through its 2D position at the metric depth of
  its NDC depth, with in-plane 3D scales = pixel scales * z / f and an
  in-plane rotation about the view axis; SH degree 3 with the colour in
  the DC term and small random higher-order terms (seed 3)."""
  w, h = image_size
  fx = fy = 0.5 * w / math.tan(0.5 * math.radians(fov_deg))
  cx, cy = w / 2.0, h / 2.0

  z = 1.0 / (1.0 / near + depth_ndc * (1.0 / far - 1.0 / near))
  x3 = (packed[:, 0] - cx) * z / fx
  y3 = (packed[:, 1] - cy) * z / fy

  s_px = packed[:, 4:6]
  s3 = s_px * (z / fx)[:, None]
  log_scaling = np.log(np.concatenate(
      [s3, np.minimum(s3[:, :1], s3[:, 1:])], -1).astype(np.float32))

  theta = np.arctan2(packed[:, 3], packed[:, 2])
  quat = np.zeros((packed.shape[0], 4), np.float32)
  quat[:, 2] = np.sin(0.5 * theta)
  quat[:, 3] = np.cos(0.5 * theta)

  a = np.clip(packed[:, 6], 1e-4, 1 - 1e-4)
  alpha_logit = np.log(a / (1 - a)).astype(np.float32)[:, None]

  n = packed.shape[0]
  sh = np.zeros((n, 3, 16), np.float32)
  sh[:, :, 0] = feats / 0.28209479177387814
  sh[:, :, 1:] = np.random.default_rng(3).normal(
      0.0, 0.02, (n, 3, 15)).astype(np.float32)

  def t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)

  g3d = Gaussians3D(
      position=t(np.stack([x3, y3, z], -1)),
      log_scaling=t(log_scaling),
      rotation=t(quat),
      alpha_logit=t(alpha_logit),
      feature=t(sh))
  cam = CameraParams(
      projection=t(np.asarray([fx, fy, cx, cy])),
      T_camera_world=torch.eye(4, dtype=torch.float32, device=device),
      near_plane=near, far_plane=far, image_size=image_size)
  return g3d, cam
