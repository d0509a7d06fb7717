"""Spherical-harmonics shading (plain torch).

Counterpart of ``tpu_splatting/spherical_harmonics.py``: a basis
evaluation plus a per-point contraction; autograd differentiates it for
the coefficients, the positions and the camera position.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import trace
from .lib import transforms
from .lib.sh import check_sh_degree, rsh_cart


def evaluate_sh_at(
    sh_params: torch.Tensor,     # (N, K, (d+1)^2) coefficients
    positions: torch.Tensor,     # (N, 3)
    camera_pos: torch.Tensor,    # (3,)
    indexes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
  """SH colour of each gaussian as seen from ``camera_pos``: (N, K),
  offset by +0.5 and clamped to [0, 1]."""
  degree = check_sh_degree(sh_params)

  with trace.span("sh"):
    if indexes is not None:
      sh_params = sh_params[indexes]
      positions = positions[indexes]

    direction = transforms.normalize(positions - camera_pos)
    basis = rsh_cart(direction, degree)              # (N, B)
    out = torch.einsum("nkb,nb->nk", sh_params, basis)
    return torch.clamp(out + 0.5, 0.0, 1.0)
