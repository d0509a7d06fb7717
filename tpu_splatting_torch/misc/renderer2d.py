"""2D gaussian path: packing, bases, split operations, 2D renderer.

Counterpart of ``tpu_splatting/misc/renderer2d.py``.  Plain torch around
the rasterizer (``rasterizer.function.rasterize``: K1 and K2 on the stream
pipeline, K4-K7 on the sorted one).  Random draws take an explicit
``torch.Generator`` where the reference takes a ``jax.random`` key; the
numbers are drawn on the generator's device and moved to the points'
device, so a CPU generator gives a run on the card and one on the CPU the
same draws.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..data_types import Gaussians2D, RasterConfig
from ..lib import transforms


def project_gaussians2d(points: Gaussians2D) -> torch.Tensor:
  """Pack Gaussians2D into the (N, 7) axis/sigma representation of the
  tile mappers and rasterizers: position, unit axis, scaling, alpha."""
  alpha = transforms.sigmoid(points.alpha_logit[:, 0])
  return torch.cat([points.position, transforms.normalize(points.rotation),
                    points.scaling, alpha[:, None]], -1)


def _axes(points: Gaussians2D):
  v1 = transforms.normalize(points.rotation)
  return v1, torch.stack([-v1[..., 1], v1[..., 0]], -1)


def point_basis(points: Gaussians2D, eps: float = 1e-4) -> torch.Tensor:
  """Per-point scaled basis (N, 2, 2): columns v1 s1, v2 s2."""
  scale = torch.clamp(points.scaling, min=eps)
  return torch.stack(_axes(points), -1) * scale[:, None, :]


def point_rotation(points: Gaussians2D) -> torch.Tensor:
  return torch.stack(_axes(points), 1)


def point_covariance(points: Gaussians2D) -> torch.Tensor:
  basis = point_basis(points)
  return basis @ basis.transpose(1, 2)


def _draw(fn, shape, generator: Optional[torch.Generator],
          like: torch.Tensor) -> torch.Tensor:
  """fn(shape) (``torch.randn`` or ``torch.rand``) drawn from
  ``generator`` on its device, as ``like``'s dtype on ``like``'s
  device."""
  dev = generator.device if generator is not None else like.device
  return fn(shape, generator=generator, dtype=like.dtype,
            device=dev).to(like.device)


def split_with_offsets(points: Gaussians2D, offsets: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       depth_noise: float = 1e-2) -> Gaussians2D:
  """Repeat each gaussian n times and displace the copies by offsets
  (N, n, 2); the depths get normal noise of ``depth_noise`` and stay at
  least 1e-6."""
  n = offsets.shape[1]
  rep = Gaussians2D(**{f.name: getattr(points, f.name).repeat_interleave(
      n, 0) for f in dataclasses.fields(points)})
  jitter = _draw(torch.randn, rep.depths.shape, generator, rep.depths)
  return rep.replace(
      position=rep.position + offsets.reshape(-1, 2),
      depths=torch.clamp(rep.depths + jitter * depth_noise, min=1e-6))


def repeat_sample_gaussians(samples: torch.Tensor, points: Gaussians2D,
                            n: int = 2) -> torch.Tensor:
  """(N, n, 2): each point's n samples (in its unit frame) through its
  basis."""
  basis = point_basis(points).repeat_interleave(n, 0)
  return (basis @ samples.reshape(-1, 2, 1)).reshape(-1, n, 2)


def split_gaussians2d(points: Gaussians2D,
                      generator: Optional[torch.Generator] = None, n: int = 2,
                      scaling: Optional[float] = None,
                      depth_noise: float = 1e-2) -> Gaussians2D:
  """Randomly sampled split: n copies at normal offsets of half a sigma,
  scaled by ``scaling`` (1 / sqrt(n))."""
  samples = 0.5 * _draw(torch.randn, (len(points), n, 2), generator,
                        points.position)
  offsets = repeat_sample_gaussians(samples, points, n)
  if scaling is None:
    scaling = 1 / math.sqrt(n)
  points = points.replace(log_scaling=points.log_scaling + math.log(scaling))
  return split_with_offsets(points, offsets, generator, depth_noise)


def uniform_split_gaussians2d(points: Gaussians2D,
                              generator: Optional[torch.Generator] = None,
                              n: int = 2, scaling: Optional[float] = None,
                              depth_noise: float = 1e-2, sep: float = 0.7,
                              random_axis: bool = False, eps: float = 1e-6
                              ) -> Gaussians2D:
  """Axis-aligned uniform split: n copies spread over [-sep, sep] sigma
  along one axis (the larger, or one drawn with probability proportional
  to its scale), that axis's scale times ``scaling`` (sqrt(n) / n)."""
  if random_axis:
    probs = points.scaling + eps
    probs = probs / probs.sum(-1, keepdim=True)
    dev = generator.device if generator is not None else probs.device
    axis_idx = torch.multinomial(probs.detach().to(dev), 1,
                                 generator=generator)[:, 0].to(probs.device)
  else:
    axis_idx = torch.argmax(points.log_scaling, -1)
  dtype = points.position.dtype
  axis = torch.nn.functional.one_hot(axis_idx, 2).to(dtype)
  values = torch.linspace(-sep, sep, n, dtype=dtype,
                          device=points.position.device)
  samples = values.reshape(1, -1, 1) * axis.reshape(-1, 1, 2)
  offsets = repeat_sample_gaussians(samples, points, n)
  if scaling is None:
    scaling = math.sqrt(n) / n
  points = points.set_scaling(points.scaling * (axis * scaling + (1 - axis)))
  return split_with_offsets(points, offsets, generator, depth_noise)


def render_gaussians(gaussians: Gaussians2D, image_size: Tuple[int, int],
                     raster_config: RasterConfig = RasterConfig(),
                     max_overlaps: Optional[int] = None,
                     heuristic_probe: Optional[torch.Tensor] = None,
                     probe: Optional[torch.Tensor] = None):
  """Render 2D gaussians (depths clipped to [0, 1]): the rasterizer's
  ``RasterOut``."""
  from ..rasterizer.function import rasterize
  return rasterize(
      gaussians2d=project_gaussians2d(gaussians),
      depth=torch.clamp(gaussians.depths, 0.0, 1.0),
      features=gaussians.feature,
      image_size=image_size,
      config=raster_config,
      max_overlaps=max_overlaps,
      heuristic_probe=heuristic_probe,
      probe=probe)


def render_with_heuristics(loss_fn, gaussians: Gaussians2D,
                           image_size: Tuple[int, int],
                           config: RasterConfig = RasterConfig(),
                           max_overlaps: Optional[int] = None):
  """Render, evaluate ``loss_fn(out, gaussians)`` and run the backward
  pass: ``(loss, out, grads)`` with ``out.point_heuristic`` (columns
  prune_cost, split_score) from the same backward as ``grads`` (a
  ``Gaussians2D`` of the gradients of every leaf).

  The heuristics are the gradient of a zero-valued probe input.  On the
  stream pipeline visibility is a backward product too: the probe's
  leading column, whose gradient fills ``out.visibility`` (the sorted
  pipeline computes it in the forward).  ``gaussians`` is not modified:
  the step differentiates detached copies of its leaves."""
  assert config.compute_point_heuristic, (
      "render_with_heuristics requires config.compute_point_heuristic")
  from ..rasterizer.stream_function import probe_width, stream_eligible

  use_stream = stream_eligible(config, image_size)
  leaves = [getattr(gaussians, f.name).detach().requires_grad_(True)
            for f in dataclasses.fields(gaussians)]
  pw = probe_width(config) if use_stream else 2
  probe = torch.zeros((leaves[0].shape[0], pw), dtype=leaves[0].dtype,
                      device=leaves[0].device, requires_grad=True)
  kw = {"probe": probe} if use_stream else {"heuristic_probe": probe}
  with torch.enable_grad():
    g = Gaussians2D(*leaves)
    out = render_gaussians(g, image_size, config, max_overlaps, **kw)
    loss = loss_fn(out, g)
    grads = torch.autograd.grad(loss, leaves + [probe], allow_unused=True)
  grads = [torch.zeros_like(x) if d is None else d
           for x, d in zip(leaves + [probe], grads)]
  gpr = grads[-1]
  out = out._replace(image=out.image.detach(),
                     image_weight=out.image_weight.detach())
  if use_stream:
    out = out._replace(point_heuristic=gpr[:, pw - 2:],
                       visibility=gpr[:, 0] if pw == 3 else None)
  else:
    out = out._replace(point_heuristic=gpr,
                       visibility=None if out.visibility is None else
                       out.visibility.detach())
  return loss.detach(), out, Gaussians2D(*grads[:-1])
