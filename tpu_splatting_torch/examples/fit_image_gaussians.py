"""Fit random 2D gaussians to an image: the end-to-end training example.

Counterpart of ``examples/fit_image_gaussians.py``: project2d ->
rasterize (visibility + heuristics) -> MSE + opacity/scale regularisers ->
visibility-aware fractional optimizer step with a per-point basis ->
parameter clamps, with split/prune between epochs driven by the
prune-cost / split-score heuristics of the backward pass.  On the card
each step launches the stream pipeline's K1 and K2 once.

One eager step a call (no jit); split/prune happens between epochs, when
the point count changes.  Every random draw (the initial splats, the
split axes and depth noise) comes from a CPU ``torch.Generator`` seeded by
``--seed`` and is moved to the device, so a run on the card and one on
the CPU draw the same numbers.

    python -m tpu_splatting_torch.examples.fit_image_gaussians [image.png]
        [--device cuda|cpu] [--n N] [--iters I] ...

(no image -> a procedural target, so no data file is needed).  It runs on
the card unless ``--device cpu`` is given, and raises without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .. import trace
from ..data_types import Gaussians2D, RasterConfig
from ..lib.transforms import inverse_sigmoid
from ..misc.renderer2d import (point_basis, project_gaussians2d,
                               render_with_heuristics,
                               uniform_split_gaussians2d)
from ..optim import GroupConfig, ParameterClass, VisibilityAwareLaProp
from ..utils.check_finite import check_finite


def parse_args(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument("image_file", type=str, nargs="?", default=None)
  parser.add_argument("--device", default="cuda",
                      help="cuda (the default) or cpu")
  parser.add_argument("--seed", type=int, default=0)
  parser.add_argument("--tile_size", type=int, default=16)
  parser.add_argument("--n", type=int, default=1000)
  parser.add_argument("--target", type=int, default=None)
  parser.add_argument("--prune", action="store_true")
  parser.add_argument("--iters", type=int, default=2000)
  parser.add_argument("--max_lr", type=float, default=0.5)
  parser.add_argument("--min_lr", type=float, default=0.1)
  parser.add_argument("--epoch", type=int, default=8)
  parser.add_argument("--max_epoch", type=int, default=32)
  parser.add_argument("--prune_rate", type=float, default=0.025)
  parser.add_argument("--opacity_reg", type=float, default=0.00001)
  parser.add_argument("--scale_reg", type=float, default=0.1)
  parser.add_argument("--antialias", action="store_true")
  parser.add_argument("--max_overlaps", type=int, default=1 << 20)
  parser.add_argument("--image_size", type=str, default="256,192",
                      help="synthetic target size if no image file")
  parser.add_argument("--write_frames", type=Path, default=None)
  parser.add_argument("--profile", action="store_true",
                      help="trace one epoch with torch.profiler, the "
                      "program's spans on")
  parser.add_argument("--profile_dir", type=str,
                      default=os.path.join(tempfile.gettempdir(),
                                           "tpu_splatting_torch_trace"))
  parser.add_argument("--debug", action="store_true",
                      help="check parameters for non-finite values each epoch")
  return parser.parse_args(argv)


def log_lerp(t, a, b):
  return math.exp(math.log(b) * t + math.log(a) * (1 - t))


def psnr(a, b):
  return float(10 * torch.log10(1.0 / torch.mean((a - b) ** 2)))


def load_image(args, device) -> torch.Tensor:
  """(H, W, 3) f32 in [0, 1]: the image file, or the procedural target."""
  if args.image_file is not None:
    try:
      import cv2
      img = cv2.imread(args.image_file)
      assert img is not None, f"could not read {args.image_file}"
    except ImportError:
      from PIL import Image
      img = np.asarray(Image.open(args.image_file).convert("RGB"))
    return torch.as_tensor(img.astype(np.float32) / 255.0, device=device)
  # procedural target: smooth color field + shapes
  w, h = map(int, args.image_size.split(","))
  y, x = np.mgrid[0:h, 0:w].astype(np.float32)
  img = np.stack([
      0.5 + 0.5 * np.sin(x / 37.0) * np.cos(y / 23.0),
      0.5 + 0.5 * np.cos((x + y) / 53.0),
      ((x / w) + (y / h)) / 2,
  ], -1)
  cx, cy = w * 0.6, h * 0.4
  circle = ((x - cx) ** 2 + (y - cy) ** 2) < (min(w, h) / 4) ** 2
  img[circle] = np.array([0.9, 0.2, 0.1])
  return torch.as_tensor(img, device=device)


def random_gaussians2d(generator: torch.Generator, n, image_size,
                       alpha_range=(0.5, 1.0), scale_factor=0.5,
                       num_channels=3, device="cuda") -> Gaussians2D:
  """n random splats over the image (the reference fixture's
  distribution), drawn from ``generator`` and moved to ``device``."""
  w, h = image_size

  def rand(*shape):
    return torch.rand(shape, generator=generator,
                      device=generator.device).to(device)
  position = rand(n, 2) * torch.tensor([w, h], dtype=torch.float32,
                                       device=device)
  depth = rand(n)
  density = scale_factor * w / (1 + math.sqrt(n))
  scaling = (rand(n, 2) + 0.2) * density
  rotation = torch.randn((n, 2), generator=generator,
                         device=generator.device).to(device)
  rotation = rotation / torch.linalg.norm(rotation, dim=1, keepdim=True)
  low, high = alpha_range
  alpha = rand(n) * (high - low) + low
  return Gaussians2D(
      position=position, depths=depth, log_scaling=torch.log(scaling),
      rotation=rotation, alpha_logit=inverse_sigmoid(alpha)[:, None],
      feature=rand(n, num_channels))


def make_parameter_groups(max_lr):
  return {
      "position": GroupConfig(type="local_vector", lr=max_lr),
      "log_scaling": GroupConfig(type="scalar", lr=0.1),
      "rotation": GroupConfig(type="scalar", lr=1.0),
      "alpha_logit": GroupConfig(type="scalar", lr=0.1),
      "feature": GroupConfig(type="vector", lr=0.025),
  }


def train_step(tensors, opt_state, ref_image, *, optimizer, config,
               image_size, max_overlaps, opacity_reg, scale_reg,
               position_lr):
  """One optimization step: ``(new tensors, new optimizer state, loss,
  image, visibility, heuristics)``."""
  w, h = image_size

  def loss_fn(out, gaussians):
    scale = torch.exp(gaussians.log_scaling) / min(w, h)
    return (torch.mean((out.image - ref_image) ** 2)
            + opacity_reg * torch.mean(gaussians.opacity)
            + scale_reg * torch.mean(scale ** 2))

  gaussians = Gaussians2D(**tensors)
  loss, out, grads = render_with_heuristics(
      loss_fn, gaussians, image_size, config, max_overlaps)
  grads = {k: getattr(grads, k) for k in tensors}

  opt = optimizer(make_parameter_groups(position_lr),
                  vis_smooth=0.1, vis_beta=0.8)
  new_tensors, opt_state = opt.step(tensors, grads, opt_state,
                                    out.visibility,
                                    basis=point_basis(gaussians))

  # parameter clamps
  rot = new_tensors["rotation"]
  new_tensors["rotation"] = rot / torch.clamp(
      torch.linalg.norm(rot, dim=1, keepdim=True), min=1e-12)
  new_tensors["log_scaling"] = torch.clamp(new_tensors["log_scaling"], -5, 5)
  return (new_tensors, opt_state, loss, out.image, out.visibility,
          out.point_heuristic)


def make_epochs(total_iters, first_epoch, max_epoch):
  """Growing epoch sizes."""
  iteration, epochs = 0, []
  while iteration < total_iters:
    t = iteration / total_iters
    epoch_size = math.ceil(log_lerp(t, first_epoch, max_epoch))
    if iteration + epoch_size * 2 > total_iters:
      epoch_size = total_iters - iteration
    iteration += epoch_size
    epochs.append(epoch_size)
  return epochs


def take_n(t: np.ndarray, n: int, descending=False) -> np.ndarray:
  order = np.argsort(-t if descending else t)[:n]
  mask = np.zeros(t.shape[0], bool)
  mask[order] = True
  return mask


def find_split_prune(n, target, n_prune, prune_cost, split_score):
  prune_mask = take_n(prune_cost, n_prune, descending=False)
  target_split = max(0, (target - n) + int(prune_mask.sum()))
  split_mask = take_n(split_score, target_split, descending=True)
  both = split_mask & prune_mask
  return split_mask ^ both, prune_mask ^ both


def split_prune(params: ParameterClass, generator, t, target, prune_rate,
                heuristics: np.ndarray):
  """Prune the lowest prune_cost, split the highest split_score."""
  n = params.batch_size[0]
  split_mask, prune_mask = find_split_prune(
      n=n, target=target, n_prune=int(prune_rate * n * (1 - t)),
      prune_cost=heuristics[:, 0], split_score=heuristics[:, 1])

  to_split = params[torch.as_tensor(np.nonzero(split_mask)[0])]
  splits = uniform_split_gaussians2d(
      Gaussians2D(**to_split.tensors), generator, random_axis=True)

  keep = ~(split_mask | prune_mask)
  params = params[torch.as_tensor(np.nonzero(keep)[0])]
  params = params.append_tensors(
      {f.name: getattr(splits, f.name) for f in dataclasses.fields(splits)})
  return params, dict(split=int(split_mask.sum()), prune=int(prune_mask.sum()))


def autosize_stream_caps(config, params, image_size):
  """Size the stream pipeline's static capacities to the current scene
  (``calibrate_stream``), as the point count changes each epoch; the
  defaults are sized for millions of splats."""
  from ..mapper.tile_mapper import tile_shape
  from ..rasterizer.stream import calibrate_stream
  from ..rasterizer.stream_function import auto_group_width, stream_eligible

  if not stream_eligible(config, image_size):
    return config
  g = Gaussians2D(**params.tensors)
  gw = auto_group_width(tile_shape(image_size, config.tile_size)[0], config)
  cal = calibrate_stream(project_gaussians2d(g).detach(),
                         torch.clamp(g.depths, 0.0, 1.0).detach(),
                         g.feature.detach(), image_size, config,
                         group_width=gw)
  return dataclasses.replace(
      config, stream_num_slabs=cal["num_slabs"],
      stream_strip_cap=cal["strip_cap"], stream_slab_cap=cal["slab_cap"],
      stream_w_max=cal["w_max"], stream_run_cap=cal["run_cap"],
      stream_wide_cap=cal["wide_cap"], stream_dup_cap=cal["dup_cap"])


def main(argv=None):
  """Train; returns the final PSNR (dB) of the image against the
  target."""
  args = parse_args(argv)
  dev = torch.device(args.device)
  if dev.type == "cuda" and not torch.cuda.is_available():
    raise SystemExit("fit_image_gaussians: CUDA is not available (use "
                     "--device cpu)")
  generator = torch.Generator(device="cpu").manual_seed(args.seed)

  ref_image = load_image(args, dev)
  h, w = ref_image.shape[:2]
  image_size = (w, h)
  print(f"Image size: {w}x{h} ({dev})")

  gaussians = random_gaussians2d(generator, args.n, image_size, device=dev)
  tensors = {f.name: getattr(gaussians, f.name)
             for f in dataclasses.fields(gaussians)}
  params = ParameterClass.create(
      tensors, make_parameter_groups(args.max_lr),
      optimizer_cls=VisibilityAwareLaProp, vis_smooth=0.1, vis_beta=0.8)

  config = RasterConfig(
      compute_point_heuristic=True, compute_visibility=True,
      tile_size=args.tile_size,
      blur_cov=0.3 if not args.antialias else 0.0,
      antialias=args.antialias)
  config = autosize_stream_caps(config, params, image_size)

  lr_range = (args.max_lr, args.min_lr)
  epochs = make_epochs(args.iters, args.epoch, args.max_epoch)
  target = args.n if (args.prune and args.target is None) else args.target

  iteration = 0
  image = None
  t_start = time.time()
  for epoch_i, epoch_size in enumerate(epochs):
    t = (iteration + epoch_size * 0.5) / args.iters
    position_lr = log_lerp(t, *lr_range)

    profiler = None
    if args.profile and epoch_i == 1:   # the second epoch: warm caches
      from torch.profiler import ProfilerActivity, profile
      activities = [ProfilerActivity.CPU] + (
          [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
      profiler = profile(activities=activities)
      trace.enable()      # the program's spans: ts.* ranges in the trace
      profiler.__enter__()

    heuristics_sum = torch.zeros((params.batch_size[0], 2),
                                 dtype=torch.float32, device=dev)
    for _ in range(epoch_size):
      (new_tensors, opt_state, loss, image, visibility,
       heuristics) = train_step(
          params.tensors, params.opt_state, ref_image,
          optimizer=VisibilityAwareLaProp, config=config,
          image_size=image_size, max_overlaps=args.max_overlaps,
          opacity_reg=args.opacity_reg, scale_reg=args.scale_reg,
          position_lr=position_lr)
      params = ParameterClass(new_tensors, params.optimizer, opt_state)
      heuristics_sum = heuristics_sum + heuristics

    if profiler is not None:
      if dev.type == "cuda":
        torch.cuda.synchronize(dev)
      profiler.__exit__(None, None, None)
      trace.disable()
      os.makedirs(args.profile_dir, exist_ok=True)
      path = os.path.join(args.profile_dir, "trace.json")
      profiler.export_chrome_trace(path)
      print(f"profile trace written to {path}")

    if args.debug:
      check_finite(params.tensors, "params")
      check_finite(heuristics_sum, "heuristics")

    metrics = {
        "CPSNR": f"{psnr(ref_image, image):.2f}",
        "n": params.batch_size[0],
        "loss": f"{float(loss):.5f}",
    }

    if args.write_frames and image is not None:
      args.write_frames.mkdir(exist_ok=True, parents=True)
      frame = (np.clip(image.cpu().numpy(), 0, 1) * 255).astype(np.uint8)
      try:
        from PIL import Image
        Image.fromarray(frame).save(args.write_frames / f"{iteration:04d}.png")
      except ImportError:
        np.save(args.write_frames / f"{iteration:04d}.npy", frame)

    if target and iteration + epoch_size < args.iters:
      t_points = min((t * 2) ** 0.5, 1.0)
      tgt = math.ceil(params.batch_size[0] * (1 - t_points)
                      + t_points * target)
      params, prune_metrics = split_prune(
          params, generator, t, tgt, args.prune_rate,
          heuristics_sum.cpu().numpy())
      metrics.update(prune_metrics)
      config = autosize_stream_caps(config, params, image_size)

    iteration += epoch_size
    elapsed = time.time() - t_start
    rate = iteration / max(elapsed, 1e-9)
    print(f"iter {iteration:5d}/{args.iters}  {rate:6.1f} it/s  "
          + "  ".join(f"{k}={v}" for k, v in metrics.items()))

  final_psnr = psnr(ref_image, image)
  print(f"final PSNR: {final_psnr:.2f}  points: {params.batch_size[0]}")
  return final_psnr


if __name__ == "__main__":
  main()
