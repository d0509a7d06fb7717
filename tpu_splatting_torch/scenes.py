"""Benchmark scenes as port inputs (numpy + torch only).

``uniform_scene`` and ``heavy_scene`` are copies of the 2D scene
generators of the repository's ``bench.py`` (plain numpy: the same seed
gives the same arrays), and ``lift_to_3d`` is the counterpart of
``bench.lift_to_3d``, which builds JAX arrays.  ``random_2d_gaussians``
is a copy of the test fixture of the same name (``tests/random_data.py``),
the same numpy draws in the same order, as port tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .data_types import Gaussians2D, Gaussians3D
from .perspective.params import CameraParams


def uniform_scene(rng, n, image_size):
  """n splats uniform over the image: (packed (n, 7), NDC depth (n,),
  colours (n, 3)), all f32."""
  w, h = image_size
  density = 1.2 * w / (1 + math.sqrt(n))
  packed = np.zeros((n, 7), np.float32)
  packed[:, 0] = rng.uniform(0, w, n)
  packed[:, 1] = rng.uniform(0, h, n)
  theta = rng.uniform(0, np.pi, n)
  packed[:, 2] = np.cos(theta)
  packed[:, 3] = np.sin(theta)
  packed[:, 4:6] = (rng.random((n, 2)) + 0.2) * density
  packed[:, 6] = rng.uniform(0.1, 0.9, n)
  depth = rng.uniform(0.05, 0.95, n).astype(np.float32)
  feats = rng.random((n, 3)).astype(np.float32)
  return packed, depth, feats


def heavy_scene(rng, n, image_size):
  """3DGS-checkpoint-like statistics: log-normal projected scales (median
  ~1.3 px, long tail to ~100 px), anisotropy, opacity mass near 0 and 1
  (sigmoid of a wide logit distribution), mild spatial clustering."""
  w, h = image_size
  packed = np.zeros((n, 7), np.float32)
  n_c = 4096
  centres = np.stack([rng.uniform(0, w, n_c), rng.uniform(0, h, n_c)], 1)
  which = rng.integers(0, n_c, n)
  jitter = rng.normal(0.0, 0.08, (n, 2)) * np.asarray([w, h])
  pos = centres[which] + jitter
  packed[:, 0] = np.clip(pos[:, 0], 0, w - 1)
  packed[:, 1] = np.clip(pos[:, 1], 0, h - 1)
  theta = rng.uniform(0, np.pi, n)
  packed[:, 2] = np.cos(theta)
  packed[:, 3] = np.sin(theta)
  s_major = np.exp(rng.normal(0.35, 0.9, n)).astype(np.float32)   # px
  ratio = np.exp(-np.abs(rng.normal(0.0, 0.7, n))).astype(np.float32)
  packed[:, 4] = np.clip(s_major, 0.05, 110.0)
  packed[:, 5] = np.clip(s_major * ratio, 0.05, 110.0)
  packed[:, 6] = 1.0 / (1.0 + np.exp(-rng.normal(0.0, 2.5, n)))
  depth = rng.uniform(0.02, 0.98, n).astype(np.float32)
  feats = rng.random((n, 3)).astype(np.float32)
  return packed, depth.astype(np.float32), feats


def lift_to_3d(packed, depth_ndc, feats, image_size, near, far, fov_deg,
               device="cuda"):
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


def random_2d_gaussians(rng: np.random.Generator, n: int, image_size,
                        num_channels: int = 3, scale_factor: float = 1.0,
                        alpha_range=(0.1, 0.9), depth_range=(0.0, 1.0),
                        dtype=torch.float32, device="cuda") -> Gaussians2D:
  """n random 2D gaussians over the image, drawn from ``rng`` (an alpha
  range ending at 1 gives an alpha logit of +inf, as the fixture does)."""
  w, h = image_size
  position = rng.random((n, 2)) * np.array([w, h])
  depth = (rng.random(n) * (depth_range[1] - depth_range[0])
           + depth_range[0])

  density_scale = scale_factor * w / (1 + math.sqrt(n))
  scaling = (rng.random((n, 2)) + 0.2) * density_scale

  rotation = rng.standard_normal((n, 2))
  rotation = rotation / np.linalg.norm(rotation, axis=-1, keepdims=True)

  low, high = alpha_range
  alpha = rng.random(n) * (high - low) + low
  with np.errstate(divide="ignore"):
    alpha_logit = np.log(alpha / (1 - alpha))

  def t(x):
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
  return Gaussians2D(
      position=t(position), depths=t(depth), log_scaling=t(np.log(scaling)),
      rotation=t(rotation), alpha_logit=t(alpha_logit[:, None]),
      feature=t(rng.random((n, num_channels))))
