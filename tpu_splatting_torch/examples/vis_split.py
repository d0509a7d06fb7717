"""Visualise gaussian split operations.

Counterpart of ``examples/vis_split.py``: renders a handful of random 2D
gaussians (``scenes.random_2d_gaussians``, the reference fixture's draws
from ``--seed``), splits them (random-sampled, or ``--uniform``
axis-aligned with a random axis) and renders the result, through the
port's ``misc.renderer2d`` (K1 on the card).  The splits draw from a CPU
``torch.Generator`` seeded from ``--seed``, so the card and the CPU draw
the same numbers.  Writes PNGs (or .npy without pillow); ``--show`` uses
cv2 where it is installed.

    python -m tpu_splatting_torch.examples.vis_split [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..misc.renderer2d import (render_gaussians, split_gaussians2d,
                               uniform_split_gaussians2d)
from ..scenes import random_2d_gaussians

IMAGE_SIZE = (640, 480)


def save_or_show(name: str, image, out_dir: Path, show: bool):
  frame = (np.clip(image.cpu().numpy(), 0, 1) * 255).astype(np.uint8)
  if show:
    try:
      import cv2
      cv2.imshow(name, frame)
      while cv2.waitKey(1) == -1:
        pass
      return
    except ImportError:
      pass
  out_dir.mkdir(parents=True, exist_ok=True)
  try:
    from PIL import Image
    Image.fromarray(frame).save(out_dir / f"{name}.png")
  except ImportError:
    np.save(out_dir / f"{name}.npy", frame)
  print(f"wrote {out_dir / name}")


def main(argv=None):
  """Render before and after the split; returns both images."""
  parser = argparse.ArgumentParser()
  parser.add_argument("--n", type=int, default=5)
  parser.add_argument("--seed", type=int, default=0)
  parser.add_argument("--uniform", action="store_true",
                      help="axis-aligned split instead of random-sampled")
  parser.add_argument("--out", type=Path,
                      default=Path(tempfile.gettempdir()) / "vis_split")
  parser.add_argument("--show", action="store_true")
  parser.add_argument("--device", default="cuda",
                      help="cuda (the default) or cpu")
  args = parser.parse_args(argv)

  dev = torch.device(args.device)
  if dev.type == "cuda" and not torch.cuda.is_available():
    raise SystemExit("vis_split: CUDA is not available (use --device cpu)")

  rng = np.random.default_rng(args.seed)
  gaussians = random_2d_gaussians(rng, args.n, IMAGE_SIZE, scale_factor=0.2,
                                  alpha_range=(1.0, 1.0), device=dev)

  with torch.no_grad():
    before = render_gaussians(gaussians, IMAGE_SIZE).image
    save_or_show("before_split", before, args.out, args.show)

    generator = torch.Generator(device="cpu").manual_seed(args.seed)
    if args.uniform:
      splits = uniform_split_gaussians2d(gaussians, generator, 2,
                                         random_axis=True)
    else:
      splits = split_gaussians2d(gaussians, generator, 2)

    after = render_gaussians(splits, IMAGE_SIZE).image
    save_or_show("after_split", after, args.out, args.show)
  return before, after


if __name__ == "__main__":
  main()
