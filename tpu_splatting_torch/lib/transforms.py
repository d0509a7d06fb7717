"""Quaternion / rigid-transform math (plain torch, batched over leading axes).

Counterpart of ``tpu_splatting/lib/transforms.py``; same formulas, same
``(x, y, z, w)`` quaternion layout (``q[..., 3]`` is the scalar part).
"""

from __future__ import annotations

import torch


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
  """Unit quaternion (..., 4) [xyzw] -> rotation matrix (..., 3, 3)."""
  x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
  x2, y2, z2 = x * x, y * y, z * z

  row0 = torch.stack([1 - 2 * y2 - 2 * z2, 2 * x * y - 2 * w * z,
                      2 * x * z + 2 * w * y], -1)
  row1 = torch.stack([2 * x * y + 2 * w * z, 1 - 2 * x2 - 2 * z2,
                      2 * y * z - 2 * w * x], -1)
  row2 = torch.stack([2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x,
                      1 - 2 * x2 - 2 * y2], -1)
  return torch.stack([row0, row1, row2], -2)


def scaled_quat_to_mat(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
  """R(q) @ diag(s) without forming the diagonal."""
  return quat_to_mat(q) * s[..., None, :]


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
  """Hamilton product in xyzw layout."""
  x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
  x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
  return torch.stack([
      w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
      w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
      w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
      w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
  ], -1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
  return torch.cat([-q[..., :3], q[..., 3:]], -1)


def normalize(v: torch.Tensor, dim: int = -1,
              eps: float = 1e-12) -> torch.Tensor:
  """Safe normalise — zero vectors map to zero rather than NaN."""
  n = torch.sqrt(torch.sum(v * v, dim=dim, keepdim=True))
  return v / torch.clamp(n, min=eps)


def join_rt(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
  """(...,3,3) rotation + (...,3) translation -> (...,4,4) homogeneous."""
  batch = torch.broadcast_shapes(r.shape[:-2], t.shape[:-1])
  r = r.expand(batch + (3, 3))
  t = t.expand(batch + (3,))
  top = torch.cat([r, t[..., :, None]], -1)
  bottom = torch.zeros(batch + (1, 4), dtype=r.dtype, device=r.device)
  bottom[..., 0, 3] = 1.0
  return torch.cat([top, bottom], -2)


def split_rt(rt: torch.Tensor):
  return rt[..., :3, :3], rt[..., :3, 3]


def make_homog(p: torch.Tensor) -> torch.Tensor:
  return torch.cat([p, torch.ones_like(p[..., :1])], -1)


def transform44(m: torch.Tensor, p_homog: torch.Tensor) -> torch.Tensor:
  return p_homog @ m.transpose(-1, -2)


def transform_points(m44: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
  """Apply a 4x4 rigid/projective transform to (..., 3) points (drops w)."""
  ph = transform44(m44, make_homog(p))
  return ph[..., :3]


def sigmoid(x: torch.Tensor) -> torch.Tensor:
  return 1.0 / (1.0 + torch.exp(-x))


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
  return torch.log(x) - torch.log1p(-x)
