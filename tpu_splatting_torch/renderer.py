"""Top-level 3D renderer: projection -> (SH shading) -> NDC depth ->
tile mapping -> rasterization -> (median-depth second pass), and the
training step's ``render_with_heuristics``.

Counterpart of ``tpu_splatting/renderer.py``.  ``config.pipeline``
chooses the pipeline: the tile-stream one (``"stream"``, and ``"auto"``
below 65,536 tiles) or the sorted-overlap one (``"sorted"``).  Both stop
at about 65,535 tiles, since both keep tile ids in 16 bits: the stream
pipeline takes fewer than 65,536 tiles and the sorted mapper fewer than
65,535, and each asserts beyond, as the reference's do.  So under
``"auto"`` an image of 65,536 tiles or more fails the sorted mapper's
assertion; it is served by neither pipeline.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import trace
from .data_types import Gaussians3D, RasterConfig
from .mapper.tile_mapper import map_to_tiles
from .perspective.params import CameraParams
from .perspective.projection import ndc_depth, project_to_image
from .rasterizer.function import rasterize_with_tiles
from .rasterizer.stream_function import (probe_width, stream_eligible,
                                         stream_map_with_config,
                                         stream_rasterize_with_mapping)
from .rendering import RenderedPoints, Rendering
from .spherical_harmonics import evaluate_sh_at


def render_gaussians(
    gaussians: Gaussians3D,
    camera_params: CameraParams,
    config: RasterConfig = RasterConfig(),
    use_sh: bool = False,
    render_depth: bool = False,
    use_depth16: bool = False,
    render_median_depth: bool = False,
    max_overlaps: Optional[int] = None,
    heuristic_probe: Optional[torch.Tensor] = None,
    probe: Optional[torch.Tensor] = None,
    tiled: bool = False,
) -> Rendering:
  """Complete 3D gaussian renderer (arguments as the reference's;
  ``use_depth16`` and ``max_overlaps`` only concern the sorted pipeline)."""
  gaussians2d, depths, in_view = project_to_image(
      gaussians, camera_params, config)
  trace.grad_span(gaussians2d, "backward.project")

  if use_sh:
    features = evaluate_sh_at(
        gaussians.feature, gaussians.position.detach(),
        camera_params.camera_position)
    trace.grad_span(features, "backward.sh")
  else:
    features = gaussians.feature
    assert features.dim() == 2, (
        f"Features must be (N, C) if use_sh=False, got "
        f"{tuple(features.shape)}")

  return render_projected(
      in_view, gaussians2d, features, depths, camera_params, config,
      use_depth16=use_depth16, render_median_depth=render_median_depth,
      render_depth=render_depth, max_overlaps=max_overlaps,
      heuristic_probe=heuristic_probe, probe=probe, tiled=tiled)


def render_projected(
    in_view: torch.Tensor,
    gaussians2d: torch.Tensor,
    features: torch.Tensor,
    depths: torch.Tensor,
    camera_params: CameraParams,
    config: RasterConfig,
    use_depth16: bool = False,
    render_median_depth: bool = False,
    render_depth: bool = False,
    max_overlaps: Optional[int] = None,
    heuristic_probe: Optional[torch.Tensor] = None,
    probe: Optional[torch.Tensor] = None,
    tiled: bool = False,
) -> Rendering:
  """Rasterize already-projected gaussians.

  On the stream pipeline per-point visibility is a backward product:
  training code uses ``render_with_heuristics`` (or threads ``probe`` and
  reads its gradient).  With ``config.compute_visibility`` and no
  ``probe`` this function runs one extra backward under a zero image
  cotangent, so ``rendering.points.visibility`` is filled either way.  On
  the sorted pipeline visibility comes from the forward, and ``tiled``
  is refused, as in the reference."""
  image_size = camera_params.image_size
  use_stream = stream_eligible(config, image_size)
  ndc_depths = ndc_depth(depths, camera_params.near_plane,
                         camera_params.far_plane)
  # culled points have depth 0: keep the mapper's invalid mask
  ndc_depths = torch.where(depths > 0, ndc_depths, 0.0)

  if render_depth:
    # composite (feature, depth, depth^2) in one pass -> expectation depth
    feats_all = torch.cat([features, depths, depths ** 2], -1)
  elif render_median_depth and use_stream:
    # the stream median pass reuses the mapping's table: depth rides it
    # as a feature channel
    feats_all = torch.cat([features, depths], -1)
  else:
    feats_all = features
  f = features.shape[1]
  f_all = feats_all.shape[1]
  median_cfg = dataclasses.replace(
      config, use_alpha_blending=False,
      saturate_threshold=config.median_threshold)
  assert not tiled or use_stream, (
      "tiled rendering output is a stream-pipeline feature")

  if not use_stream:
    # the mapping is built from detached inputs; gradients flow through
    # the rasterize op's own inputs
    mapping = map_to_tiles(
        gaussians2d.detach(), ndc_depths.detach(), image_size, config,
        max_overlaps=max_overlaps, use_depth16=use_depth16,
        features=feats_all.detach())
    raster = rasterize_with_tiles(gaussians2d, feats_all, mapping,
                                  image_size, config,
                                  heuristic_probe=heuristic_probe)
    image_weight = raster.image_weight
    depth_image = (raster.image[..., f] / torch.clamp(image_weight, min=1e-10)
                   if render_depth else None)
    image = raster.image[..., :f]
    median_depth = None
    if render_median_depth:
      # another feature width than the mapping's: the gather fallback
      median_depth = rasterize_with_tiles(
          gaussians2d.detach(), depths.detach(), mapping, image_size,
          median_cfg).image[..., 0]
    visibility = raster.visibility
    overflow_by_cause = None
  else:
    pw = probe_width(config)
    if probe is None and heuristic_probe is not None and pw >= 2:
      probe = torch.cat([heuristic_probe.new_zeros(
          (heuristic_probe.shape[0], pw - 2)), heuristic_probe], -1)
    mapping = stream_map_with_config(
        gaussians2d.detach(), ndc_depths.detach(), feats_all.detach(),
        image_size, config)
    out = stream_rasterize_with_mapping(
        gaussians2d, feats_all, mapping, image_size, config, probe=probe,
        tiled=tiled)
    if tiled:
      image = out[:, :f, :]
      image_weight = out[:, f_all, :]
      depth_image = (out[:, f, :] / torch.clamp(image_weight, min=1e-10)
                     if render_depth else None)
    else:
      img_full, image_weight = out
      depth_image = (img_full[..., f] / torch.clamp(image_weight, min=1e-10)
                     if render_depth else None)
      image = img_full[..., :f]

    median_depth = None
    if render_median_depth:
      med = stream_rasterize_with_mapping(
          gaussians2d.detach(), feats_all.detach(), mapping, image_size,
          median_cfg, tiled=tiled)
      median_depth = med[:, f, :] if tiled else med[0][..., f]

    visibility = None
    if config.compute_visibility and probe is None:
      # visibility = probe column 0's cotangent under a zero image
      # cotangent (the sum of compositing weights, independent of any loss)
      with torch.enable_grad():
        probe0 = torch.zeros((gaussians2d.shape[0], pw),
                             dtype=gaussians2d.dtype,
                             device=gaussians2d.device, requires_grad=True)
        it_p = stream_rasterize_with_mapping(
            gaussians2d.detach(), feats_all.detach(), mapping, image_size,
            config, probe=probe0, tiled=True)
        (gpr,) = torch.autograd.grad(it_p, probe0, torch.zeros_like(it_p))
      visibility = gpr[:, 0]
    overflow_by_cause = mapping.overflow

  points = RenderedPoints(
      in_view=in_view,
      depths=depths,
      gaussians2d=gaussians2d,
      features=features,
      _visibility=visibility,
  )
  return Rendering(
      image=image,
      image_weight=image_weight,
      depth_image=depth_image,
      median_depth_image=median_depth,
      points=points,
      camera=camera_params,
      config=config,
      num_overflow=mapping.num_overflow,
      overflow_by_cause=overflow_by_cause,
      tiled=tiled,
  )


def render_with_heuristics(loss_fn, gaussians: Gaussians3D,
                           camera_params: CameraParams,
                           config: RasterConfig = RasterConfig(),
                           **render_kwargs):
  """Render, evaluate ``loss_fn(rendering)`` and run the backward pass:
  ``(loss, rendering, grads)`` with ``rendering.points`` visibility,
  prune_cost and split_score filled in.

  The heuristics are the gradient of a zero-valued probe input, computed
  in the same backward as ``grads`` (a ``Gaussians3D`` of the gradients of
  every leaf).  On the stream pipeline the probe is [visibility,
  prune_cost, split_score]; on the sorted pipeline it is the (N, 2)
  ``heuristic_probe`` and visibility comes from the forward.
  ``gaussians`` is not modified: the step differentiates detached copies
  of its leaves.  ``render_kwargs`` go to ``render_gaussians``."""
  assert config.compute_point_heuristic, (
      "render_with_heuristics requires config.compute_point_heuristic")
  use_stream = stream_eligible(config, camera_params.image_size)
  leaves = [getattr(gaussians, f.name).detach().requires_grad_(True)
            for f in dataclasses.fields(gaussians)]
  pw = probe_width(config) if use_stream else 2
  probe = torch.zeros((leaves[0].shape[0], pw), dtype=leaves[0].dtype,
                      device=leaves[0].device, requires_grad=True)
  kw = {"probe": probe} if use_stream else {"heuristic_probe": probe}
  with torch.enable_grad():
    rendering = render_gaussians(Gaussians3D(*leaves), camera_params, config,
                                 **kw, **render_kwargs)
    loss = loss_fn(rendering)
    with trace.span("backward"):
      grads = torch.autograd.grad(loss, leaves + [probe], allow_unused=True)
  grads = [torch.zeros_like(x) if g is None else g
           for x, g in zip(leaves + [probe], grads)]
  gpr = grads[-1]
  points = rendering.points.replace(_prune_cost=gpr[:, pw - 2],
                                    _split_score=gpr[:, pw - 1])
  if use_stream:
    points = points.replace(_visibility=gpr[:, 0])
  return (loss.detach(), rendering.replace(points=points),
          Gaussians3D(*grads[:-1]))


def viewspace_gradient(grad_gaussians2d: torch.Tensor) -> torch.Tensor:
  """Norm of the xy gradient of the projected gaussians (densify
  heuristic): pass the (N, 7) gradient of ``points.gaussians2d``."""
  assert grad_gaussians2d.shape[1] == 7
  return torch.linalg.norm(grad_gaussians2d[:, :2], dim=1)
