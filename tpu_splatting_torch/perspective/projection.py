"""Perspective EWA projection of 3D gaussians to image space (plain torch).

Counterpart of ``tpu_splatting/perspective/projection.py``: all N points
are kept, culled points get zeroed outputs (depth 0 is the cull sentinel)
and an ``in_view`` mask.  Plain torch ops, so autograd gives gradients for
the gaussian parameters and for the camera pose and intrinsics.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import trace
from ..data_types import Gaussians3D, RasterConfig
from ..lib import gaussian2d as g2d
from ..lib import transforms
from .params import CameraParams


def project_gaussians(
    position: torch.Tensor,       # (N, 3)
    log_scaling: torch.Tensor,    # (N, 3)
    rotation: torch.Tensor,       # (N, 4) xyzw
    alpha_logit: torch.Tensor,    # (N, 1)
    T_camera_world: torch.Tensor,  # (4, 4) or (3, 4) world -> camera
    projection: torch.Tensor,     # (4,) fx fy cx cy
    image_size: Tuple[int, int],
    depth_range: Tuple[float, float],
    blur_cov: float = 0.3,
    clamp_margin: float = 0.15,
    alpha_threshold: float = 1.0 / 255.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Project all gaussians: (points (N, 7), depth (N, 1), in_view (N,))."""
  f = projection[0:2]
  c = projection[2:4]
  r_cw = T_camera_world[:3, :3]
  t_cw = T_camera_world[:3, 3]
  image_size_f = torch.tensor(image_size, dtype=position.dtype,
                              device=position.device)

  in_camera = position @ r_cw.T + t_cw
  z = in_camera[:, 2]

  near, far = depth_range
  valid_z = z > near
  z_safe = torch.where(valid_z, z, torch.ones_like(z))

  uv = f * in_camera[:, 0:2] / z_safe[:, None] + c

  # clamped projection point for the Jacobian
  t_clamped = torch.minimum(
      torch.maximum(uv, -image_size_f * clamp_margin),
      (image_size_f - 1.0) * (1.0 + clamp_margin))

  # EWA: m = J @ W @ R(q) S; cov2d = m m^T
  rot_n = transforms.normalize(rotation)
  rs = transforms.scaled_quat_to_mat(rot_n, torch.exp(log_scaling))
  a = torch.einsum("ij,njk->nik", r_cw, rs)                  # W @ RS

  fx_z = f[0] / z_safe
  fy_z = f[1] / z_safe
  gx_z = (t_clamped[:, 0] - c[0]) / z_safe
  gy_z = (t_clamped[:, 1] - c[1]) / z_safe

  m0 = fx_z[:, None] * a[:, 0, :] - gx_z[:, None] * a[:, 2, :]
  m1 = fy_z[:, None] * a[:, 1, :] - gy_z[:, None] * a[:, 2, :]

  cov = torch.stack([
      (m0 * m0).sum(-1) + blur_cov,
      (m0 * m1).sum(-1),
      (m1 * m1).sum(-1) + blur_cov,
  ], -1)

  sigma, v1, v2 = g2d.eig2x2(cov)

  alpha = transforms.sigmoid(alpha_logit[:, 0])
  gscale = g2d.gaussian_scale(alpha, alpha_threshold)

  lower, upper = g2d.ellipse_bounds(
      uv, v1 * (sigma[:, 0] * gscale)[:, None],
      v2 * (sigma[:, 1] * gscale)[:, None])

  in_view = (valid_z & (z < far) & (gscale > 0)
             & torch.all(upper > 0, -1) & torch.all(lower < image_size_f, -1))

  points = g2d.pack_g2d(uv, v1, sigma, alpha)
  points = torch.where(in_view[:, None], points, torch.zeros_like(points))
  depth = torch.where(in_view, z, torch.zeros_like(z))[:, None]
  return points, depth, in_view


def project_to_image(
    gaussians: Gaussians3D, camera_params: CameraParams, config: RasterConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Project 3D gaussians to packed 2D gaussians (EWA splatting)."""
  with trace.span("project"):
    return project_gaussians(
        *gaussians.shape_tensors(),
        camera_params.T_camera_world,
        camera_params.projection,
        camera_params.image_size,
        camera_params.depth_range,
        blur_cov=config.blur_cov,
        clamp_margin=config.clamp_margin,
        alpha_threshold=config.alpha_threshold,
    )


def ndc_depth(depth, near: float, far: float):
  """Depth -> [0, 1] NDC."""
  return 1.0 - (1.0 / depth - 1.0 / far) / (1.0 / near - 1.0 / far)


def inverse_ndc_depth(ndc, near: float, far: float):
  """NDC [0, 1] -> depth."""
  return 1.0 / ((1.0 - ndc) * (1.0 / near - 1.0 / far) + 1.0 / far)


def unproject_points(uv, depth, T_image_world):
  """Image uv + depth -> world points (inverse of the camera's
  ``T_image_world``)."""
  t_world_image = torch.linalg.inv(T_image_world)
  depth = depth if depth.dim() == uv.dim() else depth[..., None]
  homog = torch.cat([uv * depth, depth, torch.ones_like(depth)], -1)
  world = homog @ t_world_image.transpose(-1, -2)
  return world[..., :3] / world[..., 3:4]
