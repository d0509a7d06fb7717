"""Rendering output types (dataclasses of tensors).

Counterpart of ``tpu_splatting/rendering.py``: ``RenderedPoints`` covers
all N points with an ``in_view`` mask; ``Rendering`` holds the images and
the mapper's overflow counts.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from .data_types import RasterConfig
from .perspective.params import CameraParams
from .perspective.projection import ndc_depth


@dataclass
class RenderedPoints:
  """Per-point outputs of a render."""
  in_view: torch.Tensor              # (N,) bool
  depths: torch.Tensor               # (N, 1)
  gaussians2d: torch.Tensor          # (N, 7)
  features: torch.Tensor             # (N, F)

  _visibility: Optional[torch.Tensor] = None    # (N,)
  _prune_cost: Optional[torch.Tensor] = None    # (N,)
  _split_score: Optional[torch.Tensor] = None   # (N,)

  @property
  def idx(self) -> torch.Tensor:
    return torch.arange(self.in_view.shape[0], device=self.in_view.device)

  @property
  def visibility(self) -> torch.Tensor:
    assert self._visibility is not None, (
        "No visibility available (render with config.compute_visibility)")
    return self._visibility

  @property
  def prune_cost(self) -> torch.Tensor:
    assert self._prune_cost is not None, "No prune cost available"
    return self._prune_cost

  @property
  def split_score(self) -> torch.Tensor:
    assert self._split_score is not None, "No split score available"
    return self._split_score

  @property
  def visible_mask(self) -> torch.Tensor:
    return self.visibility > 0.0

  @property
  def screen_scale(self) -> torch.Tensor:
    return self.gaussians2d[:, 4:6]

  @property
  def opacity(self) -> torch.Tensor:
    return self.gaussians2d[:, 6]

  def gaussian_scale(self, alpha_threshold: float = 1.0 / 255.0):
    return torch.sqrt(torch.clamp(
        2.0 * torch.log(torch.clamp(self.opacity, min=1e-30)
                        / alpha_threshold), min=0.0))

  def replace(self, **kw):
    return dataclasses.replace(self, **kw)


@dataclass
class Rendering:
  """Full render output.  With ``tiled`` the image fields stay in tile
  layout: image (T, C, PIX), image_weight / depth images (T, PIX)."""
  image: torch.Tensor                          # (H, W, C) | (T, C, PIX)
  image_weight: torch.Tensor                   # (H, W)    | (T, PIX)

  points: RenderedPoints
  camera: CameraParams
  config: RasterConfig

  depth_image: Optional[torch.Tensor] = None
  median_depth_image: Optional[torch.Tensor] = None
  # () i32 — rows dropped by the mapper's static capacities; a render is
  # exact only when this is 0
  num_overflow: Optional[torch.Tensor] = None
  # (5,) i32 — the same by cause [wide, strip, slab, run, window]
  overflow_by_cause: Optional[torch.Tensor] = None
  tiled: bool = False

  @property
  def ndc_image(self) -> torch.Tensor:
    return ndc_depth(self.depth_image, self.camera.near_plane,
                     self.camera.far_plane)

  @property
  def median_ndc_image(self) -> torch.Tensor:
    return ndc_depth(self.median_depth_image, self.camera.near_plane,
                     self.camera.far_plane)

  @property
  def in_view_mask(self) -> torch.Tensor:
    return self.points.in_view

  @property
  def image_size(self):
    return self.camera.image_size

  def replace(self, **kw):
    return dataclasses.replace(self, **kw)
