"""Minimal backward smoke run.

Counterpart of ``examples/test_backward.py``: render a few large
low-alpha 2D gaussians (``scenes.random_2d_gaussians`` from
``np.random.default_rng(0)``, the reference's draws) through the port's
``misc.renderer2d`` and pull the gradient of the image's sum through the
whole 2D pipeline (K1 and K2 on the card).

    python -m tpu_splatting_torch.examples.test_backward [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ..data_types import RasterConfig
from ..misc.renderer2d import render_gaussians
from ..scenes import random_2d_gaussians

IMAGE_SIZE = (640, 480)


def main(argv=None):
  """Returns the loss and {field: gradient}, each checked finite."""
  parser = argparse.ArgumentParser()
  parser.add_argument("--n", type=int, default=1)
  parser.add_argument("--tile_size", type=int, default=16)
  parser.add_argument("--device", default="cuda",
                      help="cuda (the default) or cpu")
  args = parser.parse_args(argv)

  dev = torch.device(args.device)
  if dev.type == "cuda" and not torch.cuda.is_available():
    raise SystemExit("test_backward: CUDA is not available (use --device "
                     "cpu)")

  config = RasterConfig(tile_size=args.tile_size)
  rng = np.random.default_rng(0)
  gaussians = random_2d_gaussians(rng, args.n, IMAGE_SIZE, scale_factor=10.0,
                                  alpha_range=(0.2, 0.3), device=dev)
  for f in dataclasses.fields(gaussians):
    getattr(gaussians, f.name).requires_grad_()

  out = render_gaussians(gaussians, IMAGE_SIZE, config)
  loss = torch.sum(out.image)
  loss.backward()
  grads = {}
  for name in ("position", "log_scaling", "rotation", "alpha_logit",
               "feature"):
    g = getattr(gaussians, name).grad
    if not torch.isfinite(g).all():
      raise FloatingPointError(f"non-finite gradient in {name}")
    print(f"{name}: |grad| = {float(g.abs().sum()):.6f}")
    grads[name] = g
  print(f"loss = {loss.item():.6f} — backward OK")
  return loss.item(), grads


if __name__ == "__main__":
  main()
