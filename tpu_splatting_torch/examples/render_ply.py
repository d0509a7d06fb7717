"""Render a 3DGS checkpoint PLY from a chosen viewpoint.

Counterpart of ``examples/render_ply.py``: load a checkpoint
(``io.ply.load_gaussians``), place a camera, render with the SH colours
(``render_gaussians(..., use_sh=True)``: K1 on the card), save the image.

    python -m tpu_splatting_torch.examples.render_ply scene.ply \
        --image_size 1024,768 --camera 0,0,-5 --look_at 0,0,0 --fov 60 \
        --out render.npy [--device cuda|cpu]

``--synthetic N`` first writes a random N-splat scene to the PLY, drawn
from ``np.random.default_rng(0)`` as the reference example draws it, so
the file is byte for byte the reference's.  It renders with the
reference's default ``RasterConfig()`` (no calibration) and warns when
the stream capacities overflow.  It runs on the card unless ``--device
cpu`` is given, and raises without one.
"""

from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

import numpy as np
import torch

from ..data_types import Gaussians3D, RasterConfig
from ..io.ply import load_gaussians, save_gaussians
from ..perspective import CameraParams
from ..renderer import render_gaussians


def look_at_pose(eye, target, up=(0.0, 1.0, 0.0)):
  """World->camera rigid transform (OpenCV convention: +z forward)."""
  eye = np.asarray(eye, np.float32)
  fwd = np.asarray(target, np.float32) - eye
  fwd = fwd / np.linalg.norm(fwd)
  right = np.cross(fwd, np.asarray(up, np.float32))
  right = right / np.linalg.norm(right)
  down = np.cross(fwd, right)
  r = np.stack([right, down, fwd], 0)            # camera rows
  t = -r @ eye
  m = np.eye(4, dtype=np.float32)
  m[:3, :3] = r
  m[:3, 3] = t
  return m


def synthetic_checkpoint(path, n, seed=0):
  rng = np.random.default_rng(seed)

  def t(x):
    return torch.from_numpy(np.asarray(x, np.float32))
  g = Gaussians3D(
      position=t(rng.normal(0.0, 1.2, (n, 3))),
      log_scaling=t(rng.normal(-3.5, 0.5, (n, 3))),
      rotation=t(rng.normal(size=(n, 4))),
      alpha_logit=t(rng.normal(0.0, 1.5, (n, 1))),
      feature=t(rng.normal(0.0, 0.3, (n, 3, 4))),
  )
  save_gaussians(path, g)


def parse_args(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument("ply", type=Path)
  p.add_argument("--image_size", default="1024,768")
  p.add_argument("--camera", default="0,0,-5")
  p.add_argument("--look_at", default="0,0,0")
  p.add_argument("--fov", type=float, default=60.0, help="horizontal, deg")
  p.add_argument("--near", type=float, default=0.1)
  p.add_argument("--far", type=float, default=100.0)
  p.add_argument("--depth", action="store_true", help="also render depth")
  p.add_argument("--out", type=Path, default=Path("render.npy"))
  p.add_argument("--synthetic", type=int, default=0,
                 help="write a random N-splat checkpoint to PLY first")
  p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
  return p.parse_args(argv)


def render(args):
  """Write the synthetic checkpoint when asked, load the PLY onto
  ``args.device`` and render it; returns the ``Rendering``."""
  dev = torch.device(args.device)
  if dev.type == "cuda" and not torch.cuda.is_available():
    raise SystemExit("render_ply: CUDA is not available (use --device cpu)")

  if args.synthetic:
    synthetic_checkpoint(str(args.ply), args.synthetic)
  gaussians = load_gaussians(str(args.ply), device=dev)
  n = gaussians.position.shape[0]
  print(f"loaded {n} splats, SH bands {gaussians.feature.shape[-1]}",
        file=sys.stderr)

  w, h = map(int, args.image_size.split(","))
  eye = [float(x) for x in args.camera.split(",")]
  tgt = [float(x) for x in args.look_at.split(",")]
  fx = (w / 2) / math.tan(math.radians(args.fov) / 2)
  camera = CameraParams(
      projection=torch.tensor([fx, fx, w / 2, h / 2], dtype=torch.float32,
                              device=dev),
      T_camera_world=torch.from_numpy(look_at_pose(eye, tgt)).to(dev),
      near_plane=args.near, far_plane=args.far, image_size=(w, h))

  with torch.no_grad():
    return render_gaussians(gaussians, camera, RasterConfig(), use_sh=True,
                            render_depth=args.depth)


def main(argv=None):
  """Render and save; returns the mean of the image weight."""
  args = parse_args(argv)
  out = render(args)
  w, h = map(int, args.image_size.split(","))
  overflow = int(out.num_overflow)
  weight_mean = float(out.image_weight.mean())
  print(f"rendered {w}x{h}: weight mean {weight_mean:.4f}"
        f", overflow {overflow}", file=sys.stderr)
  if overflow:
    print("WARNING: stream capacities overflowed — raise the"
          " RasterConfig.stream_* caps (see calibrate_stream)",
          file=sys.stderr)

  img = np.clip(out.image.cpu().numpy(), 0.0, 1.0)
  if args.out.suffix == ".npy":
    np.save(args.out, img)
  else:
    try:
      from PIL import Image
      Image.fromarray((img * 255).astype(np.uint8)).save(args.out)
    except ImportError:
      np.save(args.out.with_suffix(".npy"), img)
      print("pillow unavailable — wrote .npy instead", file=sys.stderr)
  if args.depth:
    np.save(args.out.with_suffix(".depth.npy"), out.depth_image.cpu().numpy())
  print(f"wrote {args.out}")
  return weight_mean


if __name__ == "__main__":
  main()
