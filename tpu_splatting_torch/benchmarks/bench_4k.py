"""4096 px envelope benchmark: the counterpart of ``benchmarks/bench_4k.py``.

    python -m tpu_splatting_torch.benchmarks.bench_4k [--device cuda|cpu]
        [--group-width 8]

The uniform headline scene at 4096x3072 with 2M splats (tile 16: 49,152
tiles, past 16,383, so the mapper's key layout is ``home | y | x |
depth12``, ``rasterizer.stream.depth_bits_for``) through the stream
pipeline in the trainer's configuration: calibrated and mapped by
``bench.prepare_scene`` (the port's calibration cache), checked for
``depth_bits == 12`` and no overflow, then the map call and the forward +
backward call timed by ``bench``'s closures.  Prints the card line, the
mapping, and the frame's milliseconds beside the reference's published
RTX 4090 number.
"""

from __future__ import annotations

import argparse
import sys

from .. import bench

# the reference's published RTX 4090 number at 4096 px (BASELINE.md:
# diff_gaussian_rasterization, bicycle), not a measurement of this port
BASELINE_4K_MS = 65.1
IMAGE_SIZE = (4096, 3072)
N = 2_000_000


def prepare(device="cuda", gw: int = 8, n: int = N,
            image_size=IMAGE_SIZE) -> bench.SceneSetup:
  """The uniform scene calibrated and mapped on the device; raises unless
  the mapping took the depth12 layout and dropped nothing."""
  dev = bench.device_of(device)
  arrays = bench.scene_arrays("uniform", n, image_size)
  s = bench.prepare_scene("4k", *bench.to_device(dev, *arrays), image_size,
                          gw)
  m = s.mapping
  print(f"# overflow {int(m.num_overflow)} tiles {m.num_tiles} depth_bits "
        f"{m.depth_bits}", file=sys.stderr)
  if m.depth_bits != 12:
    raise RuntimeError(f"bench_4k: {m.num_tiles} tiles took depth_bits "
                       f"{m.depth_bits}, not the >16,383-tile layout 12")
  return s


def run(s: bench.SceneSetup, iters: int = bench.ITERS) -> dict:
  """The map call and the forward + backward call, timed."""
  ms_map = bench.benchmarked("4k map", s.map_f, s.map_args, iters=iters)
  ms_raster = bench.benchmarked("4k fwd+bwd", s.fwd_bwd, s.raster_args,
                                iters=iters)
  return {"map_ms": ms_map, "raster_ms": ms_raster,
          "frame_ms": ms_map + ms_raster}


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--device", default="cuda",
                      help="cuda (the default) or cpu (the plain twins)")
  parser.add_argument("--group-width", type=int, default=8)
  args = parser.parse_args(argv)
  dev = bench.device_of(args.device)
  print(bench.card_line(dev), flush=True)
  s = prepare(dev, args.group_width)
  out = run(s)
  m = s.mapping
  print(f"4k frame: {out['frame_ms']:.3f} ms (map {out['map_ms']:.3f}, "
        f"fwd+bwd {out['raster_ms']:.3f}; {m.num_tiles} tiles, depth_bits "
        f"{m.depth_bits}); the reference's RTX 4090 number "
        f"{BASELINE_4K_MS} ms", flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
