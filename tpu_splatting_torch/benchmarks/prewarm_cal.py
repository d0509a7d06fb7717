"""Fill the port's bench calibration cache: the counterpart of
``benchmarks/prewarm_cal.py``.

    python -m tpu_splatting_torch.benchmarks.prewarm_cal [scene ...]
        [--device cuda|cpu] [--group-width 8] [--n N] [--size W H]

Scenes: ``uniform``, ``heavy``, ``uniform_full`` (default: all).  Each is
calibrated by the port's ``calibrate_stream`` as ``tpu_splatting_torch.bench``
does it (the full renderer's on the projected splats) and stored in the
port's cache, ``tpu_splatting_torch/_build/bench_cal.json``, so that a
timed run of the bench finds it.  A cache hit is a no-op.
"""

from __future__ import annotations

import argparse
import sys

from .. import bench

SCENE_NAMES = ("uniform", "heavy", "uniform_full")


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("scenes", nargs="*",
                      help=f"of {', '.join(SCENE_NAMES)} (default: all)")
  parser.add_argument("--device", default="cuda",
                      help="cuda (the default) or cpu")
  parser.add_argument("--group-width", type=int, default=8)
  parser.add_argument("--n", type=int, default=bench.N)
  parser.add_argument("--size", type=int, nargs=2, default=bench.IMAGE_SIZE,
                      metavar=("W", "H"))
  args = parser.parse_args(argv)
  unknown = sorted(set(args.scenes) - set(SCENE_NAMES))
  if unknown:
    parser.error(f"unknown scenes {unknown}")
  dev = bench.device_of(args.device)
  which = args.scenes or list(SCENE_NAMES)
  size, gw = tuple(args.size), args.group_width
  for name in ("uniform", "heavy"):
    if name in which:
      arrays = bench.to_device(dev, *bench.scene_arrays(name, args.n, size))
      cal = bench.calibrate_scene(name, *arrays, size, gw)
      print(f"# {name}: {cal}", flush=True)
  if "uniform_full" in which:
    bench.lift_and_calibrate("uniform", *bench.scene_arrays(
        "uniform", args.n, size), gw, size, dev)
  return 0


if __name__ == "__main__":
  sys.exit(main())
