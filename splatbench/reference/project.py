"""Plain reference of the 3D front end: EWA projection of 3D gaussians to
packed 2D splats, spherical-harmonics colour (degree 0-3), NDC depth.

Written from the renderer's published semantics (3D Gaussian Splatting's
EWA projection with a blur of the 2D covariance and a clamped Jacobian
point; opacity-dependent cull radius sqrt(2 ln(alpha / threshold))); it
imports nothing of the program.  Packed 2D layout: [mean_x, mean_y,
axis_x, axis_y, sigma_major, sigma_minor, alpha].
"""

from __future__ import annotations

import torch

# real SH basis constants, degrees 0-3
_C0 = 0.282094791773878
_C1 = 0.48860251190292
_C2 = (1.09254843059208, 0.94617469575756, 0.31539156525252,
       0.54627421529604)
_C3 = (0.590043589926644, 2.89061144264055, 0.304697199642977,
       1.24392110863372, 0.497568443453487, 1.44530572132028)


def _unit(v, eps=1e-12):
  return v / torch.clamp(v.square().sum(-1, keepdim=True).sqrt(), min=eps)


def _rotation(q):
  """Rotation matrices (N, 3, 3) of xyzw quaternions (normalised here)."""
  x, y, z, w = _unit(q).unbind(-1)
  x2, y2, z2 = x * x, y * y, z * z
  return torch.stack([
      torch.stack([1 - 2 * y2 - 2 * z2, 2 * x * y - 2 * w * z,
                   2 * x * z + 2 * w * y], -1),
      torch.stack([2 * x * y + 2 * w * z, 1 - 2 * x2 - 2 * z2,
                   2 * y * z - 2 * w * x], -1),
      torch.stack([2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x,
                   1 - 2 * x2 - 2 * y2], -1)], -2)


def cull_radius(alpha, threshold):
  """Radius in sigmas where the splat's alpha falls to the threshold."""
  return torch.sqrt(torch.clamp(
      2 * torch.log(torch.clamp(alpha, min=1e-30) / threshold), min=0.0))


def project(position, log_scaling, rotation, alpha_logit, world_to_camera,
            intrinsics, image_size, near, far, cfg):
  """(packed (N, 7), depth (N,)): culled splats are all zero, depth 0."""
  w, h = image_size
  fx, fy, cx, cy = position.new_tensor(intrinsics)
  size = position.new_tensor([w, h])
  rot, trans = world_to_camera[:3, :3], world_to_camera[:3, 3]
  p_cam = position @ rot.T + trans
  z = p_cam[:, 2]
  front = z > near
  zs = torch.where(front, z, torch.ones_like(z))
  uv = torch.stack([fx * p_cam[:, 0] / zs + cx, fy * p_cam[:, 1] / zs + cy],
                   -1)
  # the Jacobian is taken at the projected point clamped near the image
  uv_j = torch.minimum(torch.maximum(uv, -size * cfg["clamp_margin"]),
                       (size - 1.0) * (1.0 + cfg["clamp_margin"]))
  # the same contraction as the renderer's (W @ R S): near-isotropic
  # splats' axes hang on its rounding
  m3 = torch.einsum("ij,njk->nik", rot,
                    _rotation(rotation) * torch.exp(log_scaling)[:, None, :])
  j0 = (fx / zs)[:, None] * m3[:, 0] - ((uv_j[:, 0] - cx) / zs)[:, None] * \
      m3[:, 2]
  j1 = (fy / zs)[:, None] * m3[:, 1] - ((uv_j[:, 1] - cy) / zs)[:, None] * \
      m3[:, 2]
  a = (j0 * j0).sum(-1) + cfg["blur_cov"]
  b = (j0 * j1).sum(-1)
  c = (j1 * j1).sum(-1) + cfg["blur_cov"]
  # eigen-decomposition of [[a, b], [b, c]], the closed form: major axis
  # (a - l2, b), (1, 0) where that vanishes (an isotropic splat).  Near
  # isotropy the axis is ill-conditioned, so it is written in the order
  # the renderer's definition gives it.
  tr = a + c
  det = a * c - b * b
  root = torch.sqrt(torch.clamp(tr * tr - 4.0 * det, min=1e-18))
  l1, l2 = (tr + root) * 0.5, (tr - root) * 0.5
  ex, ey = a - l2, b
  ok = ex * ex + ey * ey > 1e-12
  ex = torch.where(ok, ex, torch.ones_like(ex))
  ey = torch.where(ok, ey, torch.zeros_like(ey))
  inv = 1.0 / torch.sqrt(ex * ex + ey * ey)
  axis = torch.stack([ex * inv, ey * inv], -1)
  sigma = torch.sqrt(torch.clamp(torch.stack([l1, l2], -1), min=1e-20))
  alpha = 1.0 / (1.0 + torch.exp(-alpha_logit[:, 0]))
  r = cull_radius(alpha, cfg["alpha_threshold"])
  ext = extent(axis, sigma, r)
  in_view = (front & (z < far) & (r > 0) & torch.all(uv + ext > 0, -1)
             & torch.all(uv - ext < size, -1))
  packed = torch.cat([uv, axis, sigma, alpha[:, None]], -1)
  packed = torch.where(in_view[:, None], packed, torch.zeros_like(packed))
  return packed, torch.where(in_view, z, torch.zeros_like(z))


def extent(axis, sigma, radius):
  """Half sizes (N, 2) of the axis-aligned box of the ellipse with
  semi-axes radius * sigma along axis and its perpendicular."""
  ax, ay = axis[:, 0], axis[:, 1]
  s1, s2 = sigma[:, 0] * radius, sigma[:, 1] * radius
  return torch.stack([torch.sqrt((ax * s1) ** 2 + (ay * s2) ** 2),
                      torch.sqrt((ay * s1) ** 2 + (ax * s2) ** 2)], -1)


def ndc(depth, near, far):
  """Metric depth -> [0, 1] NDC depth; 0 (culled) stays 0."""
  d = 1.0 - (1.0 / depth - 1.0 / far) / (1.0 / near - 1.0 / far)
  return torch.where(depth > 0, d, torch.zeros_like(d))


def sh_colour(coeffs, position, camera_position):
  """(N, 3) colour of (N, 3, 16) degree-3 SH coefficients seen from the
  camera, +0.5 and clamped to [0, 1]."""
  x, y, z = _unit(position - camera_position).unbind(-1)
  x2, y2, z2 = x * x, y * y, z * z
  basis = [torch.full_like(x, _C0), -_C1 * y, _C1 * z, -_C1 * x,
           _C2[0] * x * y, -_C2[0] * y * z, _C2[1] * z2 - _C2[2],
           -_C2[0] * x * z, _C2[3] * x2 - _C2[3] * y2,
           -_C3[0] * y * (3 * x2 - y2), _C3[1] * x * y * z,
           _C3[2] * y * (1.5 - 7.5 * z2),
           _C3[3] * z * (1.5 * z2 - 0.5) - _C3[4] * z,
           _C3[2] * x * (1.5 - 7.5 * z2), _C3[5] * z * (x2 - y2),
           -_C3[0] * x * (x2 - 3 * y2)]
  basis = torch.stack(basis[:coeffs.shape[-1]], -1)
  return torch.clamp((coeffs * basis[:, None, :]).sum(-1) + 0.5, 0.0, 1.0)
