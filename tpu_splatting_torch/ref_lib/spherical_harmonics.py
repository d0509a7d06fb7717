"""Direct per-point SH evaluation ground truth.

Counterpart of ``tpu_splatting/ref_lib/spherical_harmonics.py``:
normalise the view directions, evaluate the real SH basis, contract,
offset by +0.5 and clamp, in explicit steps, independent of the
production einsum in ``spherical_harmonics.py``.
"""

from __future__ import annotations

import torch

from ..lib.sh import check_sh_degree, rsh_cart


def reference_sh(params: torch.Tensor, positions: torch.Tensor,
                 camera_pos: torch.Tensor) -> torch.Tensor:
  """params (N, K, (d+1)^2), positions (N, 3), camera_pos (3,) -> (N, K)."""
  degree = check_sh_degree(params)
  d = positions - camera_pos
  d = d / torch.linalg.norm(d, dim=1, keepdim=True)
  basis = rsh_cart(d, degree)                       # (N, B)
  out = torch.sum(params * basis[:, None, :], dim=-1)
  return torch.clamp(out + 0.5, 0.0, 1.0)
