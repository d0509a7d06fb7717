"""Camera-batch data parallelism and point-sharded projection.

Counterpart of ``tpu_splatting/parallel/data_parallel.py`` over the
port's single-process ``Mesh`` (``mesh.py``):

* **camera data parallelism**: a batch of cameras split over the mesh's
  shards, the gaussians replicated onto each shard's device by a
  differentiable copy, each shard's losses and per-point visibility
  summed onto the first device (``psum``); the backward pass then sums
  each shard's gradients onto the leaves, as the reference's ``psum``'d
  gradients;
* **point sharding** of the projection: each shard projects its slice
  of the gaussians, and the results are gathered onto the first device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..data_types import Gaussians3D, RasterConfig
from ..optim import GroupConfig, VisibilityAwareLaProp
from ..perspective.params import CameraParams
from ..perspective.projection import project_to_image
from ..rasterizer.stream_function import probe_width
from ..renderer import render_gaussians
from .mesh import Mesh, all_gather, make_mesh, psum

__all__ = ["make_mesh", "data_parallel_loss", "make_train_step",
           "sharded_projection"]


def _replicate(gaussians: Gaussians3D, device) -> Gaussians3D:
  return Gaussians3D(*(getattr(gaussians, f.name).to(device)
                       for f in dataclasses.fields(gaussians)))


def _render_loss(gaussians: Gaussians3D, projection, t_camera_world,
                 target, camera_template: CameraParams,
                 config: RasterConfig, max_overlaps: int, probe=None):
  camera = camera_template.replace(
      projection=projection, T_camera_world=t_camera_world)
  out = render_gaussians(gaussians, camera, config,
                         max_overlaps=max_overlaps, probe=probe)
  vis = out.points._visibility
  if vis is None:
    # stream path: visibility arrives as the probe's cotangent instead
    vis = gaussians.position.new_zeros(gaussians.position.shape[0])
  return torch.mean((out.image - target) ** 2), vis


def data_parallel_loss(mesh: Mesh, camera_template: CameraParams,
                       config: RasterConfig, max_overlaps: int):
  """Mean loss and aggregated per-point visibility over a camera batch
  split over the mesh.

  Returns ``loss_fn(gaussians, probe, projections (B, 4), poses (B, 4, 4),
  targets (B, H, W, C))`` -> ``(loss, visibility (N,))``, both on the
  first device; B divides over the shards.  Differentiate the loss with
  ``torch.autograd.grad``: the gradients of the gaussians and the probe
  are summed over every camera of the batch (on the stream pipeline the
  probe's gradient is the visibility, as the reference's)."""
  n_dev = mesh.size

  def loss_fn(gaussians: Gaussians3D, probe, projections, poses, targets):
    b = projections.shape[0]
    assert b % n_dev == 0, (b, n_dev)
    per = b // n_dev
    totals, vis_totals = [], []
    for d, dev in enumerate(mesh.devices):
      g = _replicate(gaussians, dev)
      pr = None if probe is None else probe.to(dev)
      losses, vis = [], 0.0
      for i in range(d * per, (d + 1) * per):
        li, vi = _render_loss(g, projections[i].to(dev), poses[i].to(dev),
                              targets[i].to(dev), camera_template, config,
                              max_overlaps, probe=pr)
        losses.append(li)
        vis = vis + vi
      totals.append(torch.stack(losses).sum())
      vis_totals.append(vis)
    return psum(mesh, totals) / b, psum(mesh, vis_totals)

  return loss_fn


def make_train_step(mesh: Mesh, camera_template: CameraParams,
                    config: RasterConfig,
                    parameter_groups: Dict[str, GroupConfig],
                    max_overlaps: int):
  """Data-parallel training step: per-camera losses on each shard, summed
  gradients, a visibility-aware update driven by the per-point visibility
  summed over the whole camera batch.  Returns ``(train_step,
  optimizer)``; ``train_step(tensors, opt_state, projections, poses,
  targets)`` -> ``(new_tensors, new_state, loss)``, the tensors a dict of
  the ``Gaussians3D`` fields on the first device."""
  config = dataclasses.replace(config, compute_visibility=True)
  pw = probe_width(config)
  loss_fn = data_parallel_loss(mesh, camera_template, config, max_overlaps)
  optimizer = VisibilityAwareLaProp(parameter_groups)

  def train_step(tensors: Dict[str, torch.Tensor], opt_state, projections,
                 poses, targets):
    names = list(tensors)
    leaves = [tensors[k].detach().requires_grad_(True) for k in names]
    probe = leaves[0].new_zeros((leaves[0].shape[0], pw),
                                requires_grad=True)
    with torch.enable_grad():
      loss, fwd_vis = loss_fn(Gaussians3D(**dict(zip(names, leaves))),
                              probe, projections, poses, targets)
      grads = torch.autograd.grad(loss, leaves + [probe],
                                  allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves + [probe], grads)]
    # visibility: forward product on the sorted pipeline, probe gradient
    # on the stream pipeline: exactly one of the two is nonzero
    visibility = fwd_vis.detach() + grads[-1][:, 0]
    new_tensors, new_state = optimizer.step(
        tensors, dict(zip(names, grads[:-1])), opt_state, visibility)
    return new_tensors, new_state, loss.detach()

  return train_step, optimizer


def sharded_projection(mesh: Mesh, camera: CameraParams,
                       config: RasterConfig):
  """Point-sharded projection: returns ``project(gaussians)`` -> (points,
  depth, in_view) of every gaussian, gathered onto the first device; shard
  d projects the d-th of ``mesh.size`` slices of the points on its own
  device."""
  n_dev = mesh.size

  def project(gaussians: Gaussians3D):
    parts = [getattr(gaussians, f.name).tensor_split(n_dev)
             for f in dataclasses.fields(gaussians)]
    outs = [project_to_image(
        _replicate(Gaussians3D(*(p[d] for p in parts)), dev),
        camera.to(dev), config) for d, dev in enumerate(mesh.devices)]
    return tuple(all_gather(mesh, [o[k] for o in outs]) for k in range(3))

  return project
