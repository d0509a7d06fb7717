"""Projection, SH and the layout glue: the counterpart of
``benchmarks/profile_proj.py``.

    python -m tpu_splatting_torch.benchmarks.profile_proj [--device cuda|cpu]
        [--iters 10] [--n N] [--size W H]

The bench's uniform scene lifted to 3D (SH degree 3, the bench's camera)
and each piece of glue around the rasterizer alone: ``project_to_image``
forward and forward + backward (gradients of every ``Gaussians3D`` leaf),
``evaluate_sh_at`` forward and forward + backward, the NDC depth, the
detile of a tiled image, and the loss's forward + backward computed on
the detiled image and on the tiled one (the target entiled once).  The
reference asked what share of the TPU frame this glue took.  The H100
question: projection took 3.557 ms and SH 4.412 ms of a render
(``chip_smoke.py`` phase 3); what do they and their backwards cost
alone, and what does the detiled loss layout cost against the tiled one?
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from .. import bench
from ..mapper.tile_mapper import tile_shape
from ..perspective.projection import ndc_depth, project_to_image
from ..rasterizer.stream_function import detile, entile, tile_mask
from ..scenes import lift_to_3d
from ..spherical_harmonics import evaluate_sh_at
from . import diagnostics as dg


def grads_of(loss_fn, g):
  """Gradients of ``loss_fn(g)`` with respect to every leaf of ``g``."""
  leaves = [getattr(g, k.name).detach().requires_grad_(True)
            for k in dataclasses.fields(g)]
  return torch.autograd.grad(loss_fn(type(g)(*leaves)), leaves,
                             allow_unused=True)


def run(g3d, cam, depth, image_size, opts: dg.Opts) -> dict:
  config = bench._trainer_config(8)
  dev = depth.device

  def proj(g):
    return project_to_image(g, cam, config)

  def proj_loss(g):
    g2, d, _ = proj(g)
    return (g2 * g2).sum() + d.sum()

  def sh(g):
    return evaluate_sh_at(g.feature, g.position.detach(),
                          cam.camera_position)

  def ndc(d):
    return torch.where(d > 0, ndc_depth(d, cam.near_plane, cam.far_plane),
                       0.0)

  tw, th = tile_shape(image_size, config.tile_size)
  rng = np.random.default_rng(7)
  img_tiled = torch.from_numpy(rng.random(
      (tw * th, 4, config.tile_area)).astype(np.float32)).to(dev)
  tgt_full = torch.from_numpy(rng.random(
      (image_size[1], image_size[0], 3)).astype(np.float32)).to(dev)
  tgt_tiled = entile(tgt_full, tw, th, config.tile_size)
  mask = tile_mask(image_size, tw, th, config.tile_size, device=dev)

  def detile_fwd(it):
    return detile(it, tw, th, config.tile_size, image_size)

  def detiled_loss_grad(it):
    it = it.detach().requires_grad_(True)
    err = detile_fwd(it)[..., :3] - tgt_full
    return torch.autograd.grad((err * err).sum(), it)

  def tiled_loss_grad(it):
    it = it.detach().requires_grad_(True)
    err = it[:, :3] - tgt_tiled
    return torch.autograd.grad((mask * (err * err)).sum(), it)

  cases = (("proj fwd", proj, (g3d,)),
           ("proj fwd+bwd", lambda g: grads_of(proj_loss, g), (g3d,)),
           ("sh fwd", sh, (g3d,)),
           ("sh fwd+bwd", lambda g: grads_of(lambda h: (sh(h) ** 2).sum(),
                                            g), (g3d,)),
           ("ndc", ndc, (depth,)),
           ("detile fwd", detile_fwd, (img_tiled,)),
           ("detile loss f+b", detiled_loss_grad, (img_tiled,)),
           ("tiled loss f+b", tiled_loss_grad, (img_tiled,)))
  return {label: dg.timed(label, fn, args, opts) for label, fn, args in cases}


def main(argv=None) -> int:
  p = dg.parser(__doc__, iters=10)
  p.add_argument("--n", type=int, default=bench.N, help="splats")
  p.add_argument("--size", type=int, nargs=2, default=bench.IMAGE_SIZE,
                 metavar=("W", "H"), help="image size")
  args = p.parse_args(argv)
  dev = dg.start(args)
  size = tuple(args.size)
  packed, depth, feats = bench.scene_arrays("uniform", args.n, size)
  g3d, cam = lift_to_3d(packed, depth, feats, size, near=bench.NEAR,
                        far=bench.FAR, fov_deg=bench.FOV_DEG, device=dev)
  run(g3d, cam, bench.to_device(dev, depth)[0], size, dg.Opts.of(args))
  return 0


if __name__ == "__main__":
  sys.exit(main())
