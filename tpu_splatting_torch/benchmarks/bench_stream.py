"""The tile-stream pipeline's components: the counterpart of
``benchmarks/bench_stream.py``.

    python -m tpu_splatting_torch.benchmarks.bench_stream [--device cuda|cpu]
        [--n 1000000] [--width 1024] [--height 768] [--scale 4.0]
        [--iters 5] [--group-width 2] [--slab-cap 512] [--strip-cap 0]
        [--fwd-only] [--profile-fwd | --profile-bwd]

``bench_components.synthetic_2d`` splats, calibrated by the port's
``calibrate_stream`` at ``--group-width`` and ``--slab-cap`` and mapped
with the default wide and duplicate capacities, as the reference does.  A
few splats whose reach passes those capacities may be dropped: the
reference's tolerance, ``max(4, n // 100_000)``, is kept and the count
printed.  Then, each timed by ``utils.benchmarked``: ``stream_map``, the
forward (K1), the forward + backward of sum(image^2) + sum(weight), the
backward kernel alone (K2), the reduce alone (``stream_reduce``) and the
whole map + forward + backward.

``--profile-fwd`` and ``--profile-bwd`` are the reference's ablation
profiles at 2M splats at 2048x1536 (scale 1.2; group width 4 and 8): the
TPU kernels' ablations are not ported, so each is one ``torch.profiler``
session of the forward or backward kernel that prints the device time
per CUDA kernel.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from .. import bench
from ..data_types import RasterConfig
from ..rasterizer.stream import StreamMapping, calibrate_stream, stream_map
from ..rasterizer.stream_function import (stream_rasterize_with_mapping,
                                          stream_reduce)
from ..rasterizer.stream_kernels import stream_backward, stream_forward
from ..utils.benchmarked import benchmarked, profiled_kernels
from .bench_components import synthetic_2d


@dataclasses.dataclass
class StreamSetup:
  packed: torch.Tensor
  depth: torch.Tensor
  feats: torch.Tensor
  config: RasterConfig
  caps: dict
  mapping: StreamMapping
  image_size: tuple


def setup(n=1_000_000, image_size=(1024, 768), scale=4.0, gw=2,
          slab_cap=512, strip_cap=0, config=RasterConfig(),
          device="cuda") -> StreamSetup:
  """Calibrate and map the scene; raises past the reference's tolerance
  of dropped rows."""
  packed, depth, feats = synthetic_2d(n, image_size, scale_factor=scale,
                                      device=device)
  cal = calibrate_stream(packed, depth, feats, image_size, config,
                         group_width=gw, slab_cap=slab_cap)
  print(f"# calibration: {cal}", flush=True)
  if strip_cap:
    if 2 * strip_cap < cal["max_strip_rows"]:
      raise ValueError(f"--strip-cap {strip_cap}: twice it must hold "
                       f"{cal['max_strip_rows']} strip rows")
    cal["strip_cap"] = strip_cap
  caps = dict(num_slabs=cal["num_slabs"], strip_cap=cal["strip_cap"],
              slab_cap=cal["slab_cap"], group_width=gw, w_max=cal["w_max"],
              run_cap=cal["run_cap"])
  m = stream_map(packed, depth, feats, image_size, config, **caps)
  dropped, allowed = int(m.num_overflow), max(4, n // 100_000)
  print(f"# overflow: {dropped} (tolerated {allowed}) by cause "
        f"{m.overflow.tolist()} groups: {m.num_groups} slabs: "
        f"{m.num_slabs} table: {tuple(m.table.shape)}", flush=True)
  if dropped > allowed:
    raise RuntimeError(f"bench_stream: {dropped} rows dropped, more than "
                       f"the {allowed} tolerated")
  return StreamSetup(packed, depth, feats, config, caps, m, image_size)


def run(s: StreamSetup, iters=5, fwd_only=False) -> dict:
  """Each of the reference's timed calls: {name: ms}."""
  size, cfg, m = s.image_size, s.config, s.mapping
  out = {}

  def timed(name, f, args):
    out[name] = benchmarked(name, f, args, iters=iters)

  def map_f(p, d, f):
    return stream_map(p, d, f, size, cfg, **s.caps)

  def loss_grads(p, f, mm):
    p = p.detach().requires_grad_(True)
    f = f.detach().requires_grad_(True)
    img, w = stream_rasterize_with_mapping(p, f, mm, size, cfg)
    return torch.autograd.grad((img ** 2).sum() + w.sum(), (p, f))

  timed("stream_map", map_f, (s.packed, s.depth, s.feats))
  timed("stream_forward", lambda p, f, mm: stream_rasterize_with_mapping(
      p, f, mm, size, cfg)[0], (s.packed, s.feats, m))
  if fwd_only:
    return out
  timed("stream_fwd_bwd", loss_grads, (s.packed, s.feats, m))

  # the backward kernel and the reduce alone
  img = stream_forward(m, cfg)
  gimg = torch.ones_like(img)
  timed("bwd_kernel_only", lambda mm, it, gi: stream_backward(
      mm, it, gi, cfg), (m, img, gimg))
  gout = stream_backward(m, img, gimg, cfg)
  timed("reduce_only", stream_reduce, (gout, m))

  def e2e(p, d, f):
    return loss_grads(p, f, map_f(p.detach(), d, f.detach()))
  timed("stream_e2e_map_fwd_bwd", e2e, (s.packed, s.depth, s.feats))
  return out


def profile(s: StreamSetup, backward: bool, reps: int = 3) -> dict:
  """One ``torch.profiler`` session of ``reps`` forward (or backward)
  kernel calls: {CUDA kernel name: device ms per call}, also printed."""
  m, cfg = s.mapping, s.config
  img = stream_forward(m, cfg)
  gimg = torch.ones_like(img)
  fn = ((lambda: stream_backward(m, img, gimg, cfg)) if backward
        else (lambda: stream_forward(m, cfg)))
  fn()
  torch.cuda.synchronize()
  us, _ = profiled_kernels(fn, reps)
  ms = {name: t / reps / 1e3 for name, t in us.items()}
  label = "bwd" if backward else "fwd"
  for name, t in sorted(ms.items(), key=lambda kv: -kv[1]):
    print(f"{label} device time {t:.4f} ms/call  {name}", flush=True)
  return ms


def main(argv=None) -> int:
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--device", default="cuda",
                 help="cuda (the default) or cpu (the plain twins)")
  p.add_argument("--n", type=int, default=1_000_000)
  p.add_argument("--width", type=int, default=1024)
  p.add_argument("--height", type=int, default=768)
  p.add_argument("--scale", type=float, default=4.0)
  p.add_argument("--iters", type=int, default=5)
  p.add_argument("--group-width", type=int, default=2)
  p.add_argument("--slab-cap", type=int, default=512)
  p.add_argument("--strip-cap", type=int, default=0)
  p.add_argument("--fwd-only", action="store_true")
  which = p.add_mutually_exclusive_group()
  which.add_argument("--profile-fwd", action="store_true")
  which.add_argument("--profile-bwd", action="store_true")
  args = p.parse_args(argv)
  dev = bench.device_of(args.device)
  print(bench.card_line(dev), flush=True)
  if args.profile_fwd or args.profile_bwd:
    if dev.type != "cuda":
      raise SystemExit("bench_stream: the profiles read device time: they "
                       "need the card")
    # the reference's profile scenes: 2M splats at 2048x1536, scale 1.2
    gw = 4 if args.profile_fwd else 8
    config = (RasterConfig() if args.profile_fwd else RasterConfig(
        compute_point_heuristic=True, compute_visibility=True))
    s = setup(2_000_000, (2048, 1536), 1.2, gw, args.slab_cap,
              config=config, device=dev)
    profile(s, backward=args.profile_bwd)
    return 0
  s = setup(args.n, (args.width, args.height), args.scale,
            args.group_width, args.slab_cap, args.strip_cap, device=dev)
  run(s, args.iters, args.fwd_only)
  return 0


if __name__ == "__main__":
  sys.exit(main())
