"""Camera parameters (dataclass of tensors).

Counterpart of ``tpu_splatting/perspective/params.py``.  ``projection``
and ``T_camera_world`` are tensors, so autograd reaches the intrinsics and
the pose; image size and clip planes are plain Python values.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass
class CameraParams:
  projection: torch.Tensor       # (4,) [fx, fy, cx, cy]
  T_camera_world: torch.Tensor   # (4, 4) world -> camera

  near_plane: float
  far_plane: float
  image_size: Tuple[int, int]    # (width, height)

  id: Optional[int] = None

  def __post_init__(self):
    assert len(self.image_size) == 2
    assert self.near_plane > 0
    assert self.far_plane > self.near_plane

  @property
  def depth_range(self):
    return (self.near_plane, self.far_plane)

  @property
  def focal_length(self):
    return self.projection[0:2]

  @property
  def principal_point(self):
    return self.projection[2:4]

  @property
  def T_image_camera(self) -> torch.Tensor:
    fx, fy, cx, cy = (self.projection[0], self.projection[1],
                      self.projection[2], self.projection[3])
    z = torch.zeros_like(fx)
    o = torch.ones_like(fx)
    return torch.stack([
        torch.stack([fx, z, cx]),
        torch.stack([z, fy, cy]),
        torch.stack([z, z, o]),
    ])

  @property
  def T_image_world(self) -> torch.Tensor:
    t = self.T_camera_world
    k44 = torch.eye(4, dtype=t.dtype, device=t.device)
    k44 = torch.cat([
        torch.cat([self.T_image_camera.to(t.dtype),
                   torch.zeros(3, 1, dtype=t.dtype, device=t.device)], 1),
        k44[3:]], 0)
    return k44 @ t

  @property
  def camera_position(self) -> torch.Tensor:
    r = self.T_camera_world[:3, :3]
    t = self.T_camera_world[:3, 3]
    return -(r.T @ t)

  def transformed(self, t: torch.Tensor) -> "CameraParams":
    return dataclasses.replace(self, T_camera_world=t @ self.T_camera_world)

  def scale_image(self, scale: float) -> "CameraParams":
    image_size = (int(self.image_size[0] * scale),
                  int(self.image_size[1] * scale))
    return dataclasses.replace(
        self, image_size=image_size, projection=self.projection * scale)

  def to(self, *args, **kw) -> "CameraParams":
    return dataclasses.replace(
        self, projection=self.projection.to(*args, **kw),
        T_camera_world=self.T_camera_world.to(*args, **kw))

  def replace(self, **kw) -> "CameraParams":
    return dataclasses.replace(self, **kw)
