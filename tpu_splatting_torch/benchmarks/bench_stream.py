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
profiles (``profile_fwd``, ``profile_bwd``), by default at its scenes: 2M
splats at 2048x1536, scale 1.2, a calibrated mapping at group width 4
(forward) or 8 (backward, with the point heuristic and visibility; the
cotangent all ones).  Each first prints K1's counts of that mapping
(``stream_forward(..., with_counts=True)``): the computed (tile, slab)
iterations (``# ACTIVE SLAB ITERS``), the rows staged and the (row, warp)
pairs that K1's warps list, with their share of all of them.  Then it
times each profiling mode of K1 or K2 (``ablate``, in the reference's
order) by ``utils.benchmarked`` and by its device span from a flushed L2
(``utils.benchmarked.span_ms``, CUDA events; a K2 span includes the
zero fill of its buffer, alike in every mode), and prints each difference
full - mode with what it measures (``FWD_PHASES``, ``BWD_PHASES``): the
phase the mode takes out where the mode leaves the rest of the kernel's
work as it is; where the mode also changes the walk, the difference is
marked "not isolated" and names both.
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
from ..utils.benchmarked import benchmarked, l2_flusher, span_ms
from ..utils.cuda_build import block_threads
from .bench_components import synthetic_2d

# the reference's profile scene and modes, in its order
PROFILE_SCENE = dict(n=2_000_000, width=2048, height=1536, scale=1.2)
FWD_PROFILE = ("", "skeleton", "no_assemble", "no_mask", "no_alpha")
BWD_PROFILE = ("", "no_copyback", "no_mask", "no_grad", "skeleton")
# what full - mode measures: the phase the mode takes out (the reference's
# profile_bwd docstring; the forward's read alike), or, where the mode also
# changes the walk, "not isolated" and what the difference mixes
FWD_PHASES = {
    "skeleton": "the walks (all but staging, sort and write)",
    "no_assemble": "not isolated: the window assembly, and the walk over "
                   "the rows no_assemble stages instead, which miss the "
                   "tile's warps (see its walked pairs)",
    "no_mask": "not isolated: the rank sort, and the walk's change with its "
               "order (in fetch-slot order pixels freeze at other rows)",
    "no_alpha": "not isolated: the alpha formula, less the rows no_alpha's "
                "warps walk past the full kernel's early exits (it freezes "
                "no pixel): a lower bound of the formula"}
BWD_PHASES = {
    "no_copyback": "the flush into the buffer (copy-back)",
    "no_mask": "not isolated: the rank sort, and the walk's change with its "
               "order (in fetch-slot order K2 runs slower)",
    "no_grad": "the gradient chains and their reductions",
    "skeleton": "the walks (all but staging, sort and flush)"}


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


def count_totals(counts) -> tuple:
  """(iterations, rows staged, listed (row, warp) pairs) summed over the
  groups of a ``with_counts`` block."""
  return tuple(int(counts[k::8, 0].sum()) for k in range(3))


def active_counts(s: StreamSetup) -> dict:
  """K1's counts of the mapping (``with_counts``), printed as the
  reference's ``# ACTIVE SLAB ITERS`` line and one line of rows and
  walked (row, warp) pairs: {"iterations", "rows", "pairs",
  "walked_share"}."""
  m = s.mapping
  _, counts = stream_forward(m, s.config, with_counts=True)
  iters, rows, pairs = count_totals(counts)
  all_pairs = rows * (block_threads(s.config.tile_area) // 32)
  share = pairs / all_pairs if all_pairs else 0.0
  print(f"# ACTIVE SLAB ITERS: {iters} (tiles {m.num_tiles}, slabs "
        f"{m.num_slabs})", flush=True)
  print(f"# staged rows: {rows}; walked (row, warp) pairs: {pairs} of "
        f"{all_pairs} ({share:.4f}), K1's warps' footprint lists",
        flush=True)
  return {"iterations": iters, "rows": rows, "pairs": pairs,
          "walked_share": share}


def profile(s: StreamSetup, backward: bool, iters: int = 3,
            reps: int = 20) -> dict:
  """The reference's ablation profile of K1 (or K2): the counts, then
  each mode timed by ``utils.benchmarked`` (``iters`` calls) and by its
  median device span from a flushed L2 (``reps`` calls), then each
  difference full - mode and what it measures, all printed; for K1 also
  each mode's iterations, rows staged and listed pairs (a mode may change
  the walk).  Returns {"counts": ..., "modes": {mode: {"ms", "device_ms"
  [, "iterations", "rows", "pairs"]; the ablations also "full_minus_ms"
  and "measures"}}}."""
  m, cfg = s.mapping, s.config
  counts = active_counts(s)
  img = stream_forward(m, cfg)
  gimg = torch.ones_like(img)
  flush = l2_flusher(img.device)
  label = "bwd" if backward else "fwd"
  modes = {}
  for ab in BWD_PROFILE if backward else FWD_PROFILE:
    if backward:
      call = lambda mm, it, gi, ab=ab: stream_backward(mm, it, gi, cfg,
                                                       ablate=ab)
      args = (m, img, gimg)
    else:
      call = lambda mm, ab=ab: stream_forward(mm, cfg, ablate=ab)
      args = (m,)
    name = f"{label} ablate={ab or 'none'}"
    ms = benchmarked(name, call, args, iters=iters)
    dev_ms = span_ms(lambda call=call: call(*args), flush, reps)
    modes[ab] = {"ms": ms, "device_ms": dev_ms}
    walked = ""
    if not backward:
      # a mode may change the walk itself (no_assemble stages other rows)
      _, block = stream_forward(m, cfg, ablate=ab, with_counts=True)
      modes[ab].update(zip(("iterations", "rows", "pairs"),
                           count_totals(block)))
      walked = (f"; its iterations {modes[ab]['iterations']}, rows "
                f"{modes[ab]['rows']}, listed pairs {modes[ab]['pairs']}")
    print(f"{name}: {ms:.4f} ms a call (utils.benchmarked), {dev_ms:.4f} ms "
          f"device span from a flushed L2{walked}", flush=True)
  full = modes[""]["device_ms"]
  for ab, what in (BWD_PHASES if backward else FWD_PHASES).items():
    diff = full - modes[ab]["device_ms"]
    modes[ab].update(full_minus_ms=diff, measures=what)
    print(f"# full - {ab} = {diff:.4f} ms ({diff / full:.1%} of "
          f"{full:.4f}): {what}", flush=True)
  return {"counts": counts, "modes": modes}


def profile_config(backward: bool) -> RasterConfig:
  """The reference's profile config: the backward's with the point
  heuristic and visibility."""
  return (RasterConfig(compute_point_heuristic=True, compute_visibility=True)
          if backward else RasterConfig())


def run_profile(backward: bool, device="cuda", slab_cap=512, iters=3):
  """``--profile-fwd`` (``backward`` False) or ``--profile-bwd``: the
  reference's scene (``PROFILE_SCENE``, group width 4 or 8) set up and
  profiled.  Returns (the setup, ``profile``'s result)."""
  sc = PROFILE_SCENE
  s = setup(sc["n"], (sc["width"], sc["height"]), sc["scale"],
            8 if backward else 4, slab_cap, config=profile_config(backward),
            device=device)
  return s, profile(s, backward, iters)


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
    # the reference's profile scenes, whatever the scene flags say
    run_profile(args.profile_bwd, dev, args.slab_cap, min(args.iters, 3))
    return 0
  s = setup(args.n, (args.width, args.height), args.scale,
            args.group_width, args.slab_cap, args.strip_cap, device=dev)
  run(s, args.iters, args.fwd_only)
  return 0


if __name__ == "__main__":
  sys.exit(main())
