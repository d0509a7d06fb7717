"""The reference's renders and training steps, on the harness's inputs.

``cfg`` is the renderer's settings as a dict (``RENDER`` below: the
defaults every cell runs).  Nothing here imports the program."""

from __future__ import annotations

import torch

from . import project, raster
from .optim import VisibilityAdam

RENDER = {"alpha_threshold": 1.0 / 255.0, "clamp_max_alpha": 0.99,
          "saturate_threshold": 0.9999, "blur_cov": 0.3,
          "clamp_margin": 0.15}


def camera_position(world_to_camera):
  return -(world_to_camera[:3, :3].T @ world_to_camera[:3, 3])


def l2_loss(tgt, mask, weight_term=False):
  """The per-tile loss: sum(mask * (image - tgt)^2) [+ sum(mask *
  weight)]."""
  def tile_loss(out, t):
    f = tgt.shape[1]
    err = out[:, :f] - tgt[t].to(out.dtype)
    loss = (mask[t].to(out.dtype) * err * err).sum()
    if weight_term:
      loss = loss + (mask[t][:, 0].to(out.dtype) * out[:, f]).sum()
    return loss
  return tile_loss


def _as(dtype, *xs):
  return [x.detach().to(dtype) for x in xs]


def render3d(leaves, intrinsics, pose, image_size, near, far, cfg=RENDER,
             tile_loss=None, dtype=torch.float32, budget=1 << 25):
  """Project, shade and composite one view: (Result, packed 2D splats with
  their graph, SH colours with their graph, the leaves requiring
  grad)."""
  position, log_scaling, rotation, alpha_logit, feature = leaves
  grad = tile_loss is not None
  ls = [x.detach().to(dtype).requires_grad_(grad) for x in leaves]
  with torch.set_grad_enabled(grad):
    packed, depth = project.project(*ls[:4], pose.to(dtype), intrinsics,
                                    image_size, near, far, cfg)
    colour = project.sh_colour(ls[4], ls[0].detach(),
                               camera_position(pose.to(dtype)))
  # the listing is exact: keys from the float32 splats, whatever dtype
  if dtype == torch.float32:
    kp, kd = packed, depth
  else:
    kp, kd = project.project(*_as(torch.float32, *leaves[:4]),
                             pose.float(), intrinsics, image_size, near,
                             far, cfg)
  ndc = project.ndc(kd.detach(), near, far)
  pairs = raster.bin_splats(kp.detach(), ndc, image_size,
                            cfg["alpha_threshold"])
  res = raster.composite(packed, colour, pairs, cfg, tile_loss, dtype,
                         budget)
  return res, packed, colour, ls


def train3d(leaves, intrinsics, poses, image_size, near, far, tgt, mask,
            lr, cfg=RENDER, dtype=torch.float32, budget=1 << 25):
  """len(poses) training steps of the SH features from ``leaves``:
  {"loss": [per step], "grads": step 1's five leaf gradients,
  "heuristics": step 1's (visibility, prune, split), "m1": Adam's first
  moment after step 1, "feature": the features after the last step}."""
  feature = leaves[4].detach().to(dtype)
  opt = VisibilityAdam(feature, lr=lr)
  out = {"loss": []}
  for i, pose in enumerate(poses):
    cur = list(leaves[:4]) + [feature]
    res, packed, colour, ls = render3d(
        cur, intrinsics, pose, image_size, near, far, cfg,
        l2_loss(tgt, mask), dtype, budget)
    grads = torch.autograd.grad(
        (packed, colour), ls, (res.grad_packed, res.grad_features),
        allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(ls, grads)]
    out["loss"].append(res.loss)
    if i == 0:
      out["grads"] = [g.detach() for g in grads]
      out["heuristics"] = [res.visibility, res.prune_cost, res.split_score]
    feature = opt.step(feature, grads[4].detach(), res.visibility)
    if i == 0:
      out["m1"] = opt.m.clone()
    del res, packed, colour, ls, grads
  out["feature"] = feature
  return out


def train2d(packed_sets, depth, feats, image_size, tgt, mask, lr,
            cfg=RENDER, dtype=torch.float32, budget=1 << 25):
  """The 2D step (the tiled loss with its weight term) over the input
  sets in turn, the colour features trained: as ``train3d``, the
  gradients being (packed, features)."""
  feats = feats.detach().to(dtype)
  opt = VisibilityAdam(feats, lr=lr)
  ndc = depth.detach().float()
  out = {"loss": []}
  for i, packed in enumerate(packed_sets):
    pairs = raster.bin_splats(packed.float(), ndc, image_size,
                              cfg["alpha_threshold"])
    res = raster.composite(packed, feats, pairs, cfg,
                           l2_loss(tgt, mask, weight_term=True), dtype,
                           budget)
    out["loss"].append(res.loss)
    if i == 0:
      out["grads"] = [res.grad_packed, res.grad_features]
      out["heuristics"] = [res.visibility, res.prune_cost, res.split_score]
    feats = opt.step(feats, res.grad_features, res.visibility)
    if i == 0:
      out["m1"] = opt.m.clone()
    del res, pairs
  out["feature"] = feats
  return out
