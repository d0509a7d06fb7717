"""Component micro-benchmarks: the counterpart of
``benchmarks/bench_components.py``.

    python -m tpu_splatting_torch.benchmarks.bench_components
        [--device cuda|cpu] [--which all|projection|sh|tilemapper|rasterizer]
        [--n N] [--backward]

The reference's defaults (BASELINE.md's micro-bench): ``project_gaussians``
at 2M points, ``evaluate_sh_at`` at 1M points of degree 3, the sorted
pipeline's ``map_to_tiles`` and ``map_to_tiles`` + ``rasterize_with_tiles``
at 1M splats at 1024x768, tile 16 (the forward, or with ``--backward`` the
gradients of sum(image^2) + sum(weight)).  The rasterizer reaches K4, and
with ``--backward`` K5, K6 and K7.  Times by ``utils.benchmarked`` (CUDA
events on the card).

Both mapper benchmarks check ``num_overflow`` and raise if a capacity
dropped overlaps (the reference never looked).  The tile mapper keeps the
reference's ``max_overlaps = 1 << 22``.  The rasterizer's scene (scale 4)
has more overlaps than that (1 << 22 drops 37,877 of them, ROADMAP F18),
so it takes the port's ``calibrate_mapper`` capacities.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys
from typing import Optional

import numpy as np
import torch

from .. import bench
from ..data_types import RasterConfig
from ..mapper.tile_mapper import TileMapping, calibrate_mapper, map_to_tiles
from ..perspective.projection import project_gaussians
from ..rasterizer.function import rasterize_with_tiles
from ..spherical_harmonics import evaluate_sh_at
from ..utils.benchmarked import benchmarked

IMAGE_SIZE = (1024, 768)
REFERENCE_MAX_OVERLAPS = 1 << 22


def synthetic_2d(n, image_size, scale_factor=4.0, seed=0, device="cuda"):
  """n splats uniform over the image (the reference's ``synthetic_2d``:
  the same numpy draws): (packed (n, 7), depth (n,), colours (n, 3))."""
  rng = np.random.default_rng(seed)
  w, h = image_size
  density = scale_factor * w / (1 + math.sqrt(n))
  packed = np.zeros((n, 7), np.float32)
  packed[:, 0] = rng.uniform(0, w, n)
  packed[:, 1] = rng.uniform(0, h, n)
  theta = rng.uniform(0, np.pi, n)
  packed[:, 2] = np.cos(theta)
  packed[:, 3] = np.sin(theta)
  packed[:, 4:6] = (rng.random((n, 2)) + 0.2) * density
  packed[:, 6] = rng.uniform(0.1, 0.9, n)
  depth = rng.uniform(0.05, 0.95, n).astype(np.float32)
  feats = rng.random((n, 3)).astype(np.float32)
  return bench.to_device(bench.device_of(device), packed, depth, feats)


def bench_projection(n=2_000_000, iters=10, device="cuda"):
  rng = np.random.default_rng(0)
  z = rng.uniform(1, 50, n)
  dev = bench.device_of(device)
  args = bench.to_device(
      dev,
      np.stack([rng.uniform(-0.5, 0.5, n) * z,
                rng.uniform(-0.4, 0.4, n) * z, z], 1).astype(np.float32),
      rng.normal(-3, 0.5, (n, 3)).astype(np.float32),
      rng.normal(size=(n, 4)).astype(np.float32),
      rng.normal(0, 1, (n, 1)).astype(np.float32),
      np.eye(4, dtype=np.float32),
      np.asarray([1000.0, 1000.0, 512.0, 384.0], np.float32))
  f = lambda *a: project_gaussians(*a, (1024, 768), (0.1, 100.0))
  return benchmarked(f"projection n={n}", f, args, iters=iters)


def bench_sh(n=1_000_000, degree=3, iters=10, device="cuda"):
  rng = np.random.default_rng(0)
  args = bench.to_device(
      bench.device_of(device),
      (rng.standard_normal((n, 3, (degree + 1) ** 2)) * 0.3).astype(
          np.float32),
      (rng.standard_normal((n, 3)) * 5).astype(np.float32),
      rng.standard_normal(3).astype(np.float32))
  return benchmarked(f"sh n={n} deg={degree}", evaluate_sh_at, args,
                     iters=iters)


def _check_overflow(label: str, m: TileMapping, config: RasterConfig,
                    max_overlaps: int):
  caps = (f"max_overlaps {max_overlaps}, tile_window {config.tile_window}, "
          f"big_capacity {config.big_capacity}")
  dropped = int(m.num_overflow)
  print(f"# {label}: {int(m.chunk_cnt.sum())} overlaps, overflow {dropped} "
        f"at {caps}", file=sys.stderr)
  if dropped:
    raise RuntimeError(f"{label}: benchmark invalid, {dropped} overlaps "
                       f"dropped at {caps}")


def bench_tilemapper(n=1_000_000, image_size=IMAGE_SIZE, iters=5,
                     max_overlaps=REFERENCE_MAX_OVERLAPS, device="cuda"):
  packed, depth, feats = synthetic_2d(n, image_size, scale_factor=2.0,
                                      device=device)
  config = RasterConfig()
  f = lambda p, d, f_: map_to_tiles(p, d, image_size, config,
                                    max_overlaps=max_overlaps, features=f_)
  _check_overflow(f"tile_mapper n={n}", f(packed, depth, feats), config,
                  max_overlaps)
  return benchmarked(f"tile_mapper n={n}", f, (packed, depth, feats),
                     iters=iters)


@dataclasses.dataclass
class RasterizerSetup:
  packed: torch.Tensor
  feats: torch.Tensor
  mapping: TileMapping
  config: RasterConfig
  image_size: tuple
  depth: torch.Tensor
  max_overlaps: int


def rasterizer_setup(n=1_000_000, image_size=IMAGE_SIZE,
                     max_overlaps: Optional[int] = None, chunk_size=128,
                     device="cuda", scale=4.0) -> RasterizerSetup:
  """The rasterizer benchmark's scene (``synthetic_2d`` at ``scale``)
  mapped once (features as the sorted payload).  ``max_overlaps`` None:
  ``calibrate_mapper``'s window, big capacity and overlap capacity.
  Raises on overflow."""
  packed, depth, feats = synthetic_2d(n, image_size, scale_factor=scale,
                                      device=device)
  config = RasterConfig(chunk_size=chunk_size)
  if max_overlaps is None:
    cal = calibrate_mapper(packed, depth, image_size, config)
    config = dataclasses.replace(config, tile_window=cal["tile_window"],
                                 big_capacity=cal["big_capacity"])
    max_overlaps = cal["max_overlaps"]
  m = map_to_tiles(packed, depth, image_size, config,
                   max_overlaps=max_overlaps, features=feats)
  _check_overflow(f"rasterize n={n}", m, config, max_overlaps)
  return RasterizerSetup(packed, feats, m, config, image_size, depth,
                         max_overlaps)


def rasterizer_step(s: RasterizerSetup, backward: bool):
  """The timed call: the forward (``rasterize_with_tiles``) or the
  gradients of sum(image^2) + sum(weight) with respect to the splats and
  their colours."""
  def fwd(p, f_):
    return rasterize_with_tiles(p, f_, s.mapping, s.image_size, s.config)

  def fwd_bwd(p, f_):
    p = p.detach().requires_grad_(True)
    f_ = f_.detach().requires_grad_(True)
    o = fwd(p, f_)
    loss = (o.image ** 2).sum() + o.image_weight.sum()
    return torch.autograd.grad(loss, (p, f_))

  return fwd_bwd if backward else fwd


def bench_rasterizer(n=1_000_000, image_size=IMAGE_SIZE, iters=5,
                     backward=False, chunk_size=128, device="cuda"):
  s = rasterizer_setup(n, image_size, chunk_size=chunk_size, device=device)
  label = f"rasterize {'fwd+bwd' if backward else 'fwd'} n={n}"
  return benchmarked(label, rasterizer_step(s, backward),
                     (s.packed, s.feats), iters=iters)


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--device", default="cuda",
                      help="cuda (the default) or cpu (the plain twins)")
  parser.add_argument("--which", default="all",
                      choices=["all", "projection", "sh", "tilemapper",
                               "rasterizer"])
  parser.add_argument("--n", type=int, default=None)
  parser.add_argument("--backward", action="store_true")
  args = parser.parse_args(argv)
  dev = bench.device_of(args.device)
  print(bench.card_line(dev), flush=True)
  if args.which in ("all", "projection"):
    bench_projection(args.n or 2_000_000, device=dev)
  if args.which in ("all", "sh"):
    bench_sh(args.n or 1_000_000, device=dev)
  if args.which in ("all", "tilemapper"):
    bench_tilemapper(args.n or 1_000_000, device=dev)
  if args.which in ("all", "rasterizer"):
    bench_rasterizer(args.n or 1_000_000, backward=args.backward,
                     device=dev)
  return 0


if __name__ == "__main__":
  sys.exit(main())
