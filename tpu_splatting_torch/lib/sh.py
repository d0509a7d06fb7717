"""Real spherical-harmonics bases, degrees 0-4 (plain torch, batched).

Counterpart of ``tpu_splatting/lib/sh.py``: the same Cartesian
polynomials and coefficients.
"""

from __future__ import annotations

import torch


def rsh_cart(xyz: torch.Tensor, degree: int) -> torch.Tensor:
  """Real SH basis at unit directions ``xyz`` (..., 3) ->
  (..., (degree+1)**2), degree 0..4."""
  assert 0 <= degree <= 4, f"SH degree must be 0..4, got {degree}"
  x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
  one = torch.ones_like(x)

  out = [0.282094791773878 * one]
  if degree >= 1:
    out += [
        -0.48860251190292 * y,
        0.48860251190292 * z,
        -0.48860251190292 * x,
    ]
  if degree >= 2:
    x2, y2, z2 = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    out += [
        1.09254843059208 * xy,
        -1.09254843059208 * yz,
        0.94617469575756 * z2 - 0.31539156525252,
        -1.09254843059208 * xz,
        0.54627421529604 * x2 - 0.54627421529604 * y2,
    ]
  if degree >= 3:
    out += [
        -0.590043589926644 * y * (3.0 * x2 - y2),
        2.89061144264055 * xy * z,
        0.304697199642977 * y * (1.5 - 7.5 * z2),
        1.24392110863372 * z * (1.5 * z2 - 0.5) - 0.497568443453487 * z,
        0.304697199642977 * x * (1.5 - 7.5 * z2),
        1.44530572132028 * z * (x2 - y2),
        -0.590043589926644 * x * (x2 - 3.0 * y2),
    ]
  if degree >= 4:
    z4 = z2 * z2
    out += [
        2.5033429417967046 * xy * (x2 - y2),
        -1.7701307697799304 * yz * (3.0 * x2 - y2),
        0.9461746957575601 * xy * (7.0 * z2 - 1.0),
        -0.6690465435572892 * yz * (7.0 * z2 - 3.0),
        0.10578554691520431 * (35.0 * z4 - 30.0 * z2 + 3.0),
        -0.6690465435572892 * xz * (7.0 * z2 - 3.0),
        0.47308734787878004 * (x2 - y2) * (7.0 * z2 - 1.0),
        -1.7701307697799304 * xz * (x2 - 3.0 * y2),
        0.6258357354491761 * (x2 * x2 - 6.0 * x2 * y2 + y2 * y2),
    ]
  return torch.stack(out, -1)


def check_sh_degree(sh_features: torch.Tensor) -> int:
  """Infer degree from (N, K, (d+1)^2) coefficients."""
  assert sh_features.dim() == 3, (
      f"SH features must have 3 dimensions, got {tuple(sh_features.shape)}")
  n_sh = sh_features.shape[2]
  n = int(round(n_sh ** 0.5))
  assert n * n == n_sh, f"SH feature count must be square, got {n_sh}"
  return n - 1
