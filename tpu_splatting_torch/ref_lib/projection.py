"""Matrix-form EWA projection ground truth.

Counterpart of ``tpu_splatting/ref_lib/projection.py``: builds the full
3x3 covariance and 2x3 clamped Jacobian with einsums instead of the fused
per-point forms of the production op (``perspective/projection.py``).
Differentiable, camera pose and intrinsics included, so tests can diff
gradients too.
"""

from __future__ import annotations

import torch

from ..lib import gaussian2d as g2d
from ..lib import transforms


def reference_project(position, log_scaling, rotation, alpha_logit,
                      T_camera_world, projection, image_size,
                      clamp_margin=0.15, blur_cov=0.3):
  """Project 3D gaussians to packed 2D form, the slow obvious way.

  Returns (packed (N, 7) gaussians2d, z (N,) camera-space depth); no
  culling — callers mask with their own in-view logic.
  """
  f = projection[:2]
  c = projection[2:]

  in_camera = transforms.transform_points(T_camera_world, position)
  z = in_camera[:, 2]
  uv = in_camera[:, :2] * f / z[:, None] + c

  image_size_f = torch.as_tensor(image_size, dtype=position.dtype,
                                 device=position.device)
  t = torch.minimum(torch.maximum(uv, -clamp_margin * image_size_f),
                    (1.0 + clamp_margin) * (image_size_f - 1))

  zero = torch.zeros_like(z)
  J = torch.stack([
      f[0] / z, zero, -(t[:, 0] - c[0]) / z,
      zero, f[1] / z, -(t[:, 1] - c[1]) / z,
  ], 1).reshape(-1, 2, 3)

  w = T_camera_world[:3, :3]
  r = transforms.quat_to_mat(transforms.normalize(rotation))
  s = torch.exp(log_scaling)
  m = torch.einsum("ij,njk->nik", w, r * s[:, None, :])
  cov3 = m @ m.transpose(1, 2)

  cov_uv = torch.einsum("nij,njk,nlk->nil", J, cov3, J)
  cov = g2d.upper_tri(cov_uv) + torch.as_tensor(
      [blur_cov, 0.0, blur_cov], dtype=position.dtype, device=position.device)

  sigma, v1, _ = g2d.eig2x2(cov)
  alpha = transforms.sigmoid(alpha_logit[:, 0])
  return g2d.pack_g2d(uv, v1, sigma, alpha), z
