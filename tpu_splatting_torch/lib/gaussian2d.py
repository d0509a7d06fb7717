"""2D Gaussian (splat) math — packing, eigendecomposition, pdf evaluation.

Counterpart of ``tpu_splatting/lib/gaussian2d.py`` in plain torch.  Packed
layout (7 floats): ``[mean_x, mean_y, axis_x, axis_y, sigma_x, sigma_y,
alpha]`` — ``axis`` is the unit major eigenvector of the image-space
covariance, ``sigma`` the std-devs along the major / minor axes, ``alpha``
the post-sigmoid opacity.
"""

from __future__ import annotations

import math

import torch

G2D_SIZE = 7


def pack_g2d(mean, axis, sigma, alpha) -> torch.Tensor:
  """Pack components into the (..., 7) layout."""
  return torch.cat([mean, axis, sigma, alpha[..., None]], -1)


def unpack_g2d(vec: torch.Tensor):
  """(..., 7) -> (mean, axis, sigma, alpha)."""
  return vec[..., 0:2], vec[..., 2:4], vec[..., 4:6], vec[..., 6]


def perp(v: torch.Tensor) -> torch.Tensor:
  """90-degree rotation of a 2-vector."""
  return torch.stack([-v[..., 1], v[..., 0]], -1)


def eig2x2(cov: torch.Tensor, eps: float = 1e-12):
  """Closed-form eigendecomposition of a symmetric 2x2 matrix given as its
  upper-triangular entries ``(a, b, c)``.  Returns ``(sigma, v1, v2)``:
  sqrt eigenvalues (descending), unit major axis, ``perp(v1)``.
  Near-isotropic covariances fall back to ``v1 = (1, 0)``."""
  a, b, c = cov[..., 0], cov[..., 1], cov[..., 2]
  tr = a + c
  det = a * c - b * b

  gap = tr * tr - 4.0 * det
  sqrt_gap = torch.sqrt(torch.clamp(gap, min=1e-18))

  lam1 = (tr + sqrt_gap) * 0.5
  lam2 = (tr - sqrt_gap) * 0.5

  vx, vy = a - lam2, b
  n2 = vx * vx + vy * vy
  safe = n2 > eps
  vx_s = torch.where(safe, vx, torch.ones_like(vx))
  vy_s = torch.where(safe, vy, torch.zeros_like(vy))
  inv_n = 1.0 / torch.sqrt(vx_s * vx_s + vy_s * vy_s)
  v1 = torch.stack([vx_s * inv_n, vy_s * inv_n], -1)
  v2 = perp(v1)

  sigma = torch.sqrt(torch.clamp(torch.stack([lam1, lam2], -1), min=1e-20))
  return sigma, v1, v2


def ellipse_bounds(uv: torch.Tensor, a1: torch.Tensor, a2: torch.Tensor):
  """Axis-aligned bounds of an ellipse given its two scaled axes."""
  extent = torch.sqrt(a1 * a1 + a2 * a2)
  return uv - extent, uv + extent


def gaussian_scale(alpha: torch.Tensor,
                   alpha_threshold: float) -> torch.Tensor:
  """Opacity-dependent cull radius in units of sigma,
  ``sqrt(2 ln(alpha / threshold))``, zero where alpha <= threshold."""
  return torch.sqrt(torch.clamp(
      2.0 * torch.log(torch.clamp(alpha, min=1e-30) / alpha_threshold),
      min=0.0))


def upper_tri(m: torch.Tensor) -> torch.Tensor:
  """(..., 2, 2) symmetric matrix -> (..., 3) upper entries."""
  return torch.stack([m[..., 0, 0], m[..., 0, 1], m[..., 1, 1]], -1)


def inverse_cov(cov: torch.Tensor) -> torch.Tensor:
  """Inverse of a symmetric 2x2 in upper-tri form."""
  a, b, c = cov[..., 0], cov[..., 1], cov[..., 2]
  inv_det = 1.0 / (a * c - b * b)
  return torch.stack([inv_det * c, -inv_det * b, inv_det * a], -1)


def cov_from_g2d(axis: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
  """Reconstruct upper-tri covariance from the (axis, sigma) form."""
  v2 = perp(axis)
  s1, s2 = sigma[..., 0] ** 2, sigma[..., 1] ** 2
  a = s1 * axis[..., 0] ** 2 + s2 * v2[..., 0] ** 2
  b = s1 * axis[..., 0] * axis[..., 1] + s2 * v2[..., 0] * v2[..., 1]
  c = s1 * axis[..., 1] ** 2 + s2 * v2[..., 1] ** 2
  return torch.stack([a, b, c], -1)


def conic_pdf(xy: torch.Tensor, uv: torch.Tensor,
              conic: torch.Tensor) -> torch.Tensor:
  """exp(-0.5 d^T C d) in conic form."""
  d = xy - uv
  a, b, c = conic[..., 0], conic[..., 1], conic[..., 2]
  dx, dy = d[..., 0], d[..., 1]
  inner = 0.5 * (dx * dx * a + dy * dy * c) + dx * dy * b
  return torch.exp(-inner)


def gaussian_pdf(xy: torch.Tensor, mean: torch.Tensor, axis: torch.Tensor,
                 sigma: torch.Tensor) -> torch.Tensor:
  """Un-normalised pdf in the axis/sigma parameterisation."""
  d = xy - mean
  tx = (d * axis).sum(-1) / sigma[..., 0]
  ty = (d * perp(axis)).sum(-1) / sigma[..., 1]
  return torch.exp(-0.5 * (tx * tx + ty * ty))


def s_sig(x: torch.Tensor, sigma) -> torch.Tensor:
  """Logistic approximation of the Gaussian CDF."""
  z = x / sigma
  return 1.0 / (1.0 + torch.exp(-1.6 * z - 0.07 * z ** 3))


def gaussian_pdf_antialias(xy: torch.Tensor, mean: torch.Tensor,
                           axis: torch.Tensor,
                           sigma: torch.Tensor) -> torch.Tensor:
  """Pixel-integrated (anti-aliased) pdf."""
  d = xy - mean
  sx, sy = sigma[..., 0], sigma[..., 1]
  tx = (d * axis).sum(-1)
  ty = (d * perp(axis)).sum(-1)

  ix = sx * (s_sig(tx + 0.5, sx) - s_sig(tx - 0.5, sx))
  iy = sy * (s_sig(ty + 0.5, sy) - s_sig(ty - 0.5, sy))
  return 2.0 * math.pi * ix * iy
