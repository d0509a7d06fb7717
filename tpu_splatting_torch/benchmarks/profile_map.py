"""``stream_map`` by variant: the counterpart of
``benchmarks/profile_map.py``.

    python -m tpu_splatting_torch.benchmarks.profile_map [--device cuda|cpu]
        [--scene heavy|uniform] [--gw 8] [--iters 3] [--n N] [--size W H]

The reference asked why the heavy (checkpoint-statistics) scene's map
took 598 ms on the TPU against 15 ms on the uniform one.  The H100
question: where do the heavy 2M map's 58-63 ms go (the bench's
``heavy_map_ms``), and how much of it is device work?  The scene is the
bench's (``bench.scene_arrays``, seed 1 for heavy), calibrated through the
bench's cache (``bench.prepare_scene``: the port's ``calibrate_stream`` at
group width ``--gw``).  The reference's seven variants, each a
``stream_map`` call with some capacities changed: the full map; no table
(``build_table=False``: edges and descriptors only); duplication disabled
(``wide_cap=64, dup_cap=0``), with and without the table; ``num_slabs=4``
with and without the table; ``w_max=16``.  Each line gives the call's ms
by CUDA events, the device's busy ms in it, the kernels it launched and
the busy share (``diagnostics.device_reading``).

The dup-disabled pair is "overflow ok" in the reference: it drops the
wide splats' duplicate rows, and its line gives the overflow by cause.
Any other variant that drops rows is an error.  Where ``num_slabs=4`` or
``w_max=16`` is below what the scene needs (the heavy scene at 2M needs
32 slabs and w_max 58), the variant would drop rows; it runs with that
count raised instead (``diagnostics.held_caps``: twice the calibrated
slabs, or the mapper's largest w_max) and its line says so: the H100
question there is how the descriptor build scales with slabs and
windows, which a raised count answers as well as a lowered one.
"""

from __future__ import annotations

import sys

from .. import bench
from ..rasterizer.stream import stream_map
from . import diagnostics as dg

# (label, stream_map arguments changed, overflow ok): the reference's
VARIANTS = (
    ("full map", {}, False),
    ("no table (edges/desc only)", {"build_table": False}, False),
    ("dup disabled (overflow ok)", {"wide_cap": 64, "dup_cap": 0}, True),
    ("dup, no table", {"wide_cap": 64, "dup_cap": 0, "build_table": False},
     True),
    ("slabs=4", {"num_slabs": 4}, False),
    ("slabs=4, no table", {"num_slabs": 4, "build_table": False}, False),
    ("w_max=16", {"w_max": 16}, False),
)


def variants(s: bench.SceneSetup):
  """[(label, stream_map keyword arguments, overflow ok, counts raised)]
  for the scene ``s``."""
  out = []
  for label, over, ok in VARIANTS:
    kw, raised = dg.held_caps(s.caps, over, s.cal)
    out.append((label, kw, ok, raised))
  return out


def map_call(s: bench.SceneSetup, image_size, kw: dict):
  return lambda p, d, f: stream_map(p, d, f, image_size, s.config, **kw)


def run(s: bench.SceneSetup, image_size, opts: dg.Opts) -> dict:
  """Each variant checked for overflow, then timed: {label: Timing}."""
  out = {}
  for label, kw, ok, raised in variants(s):
    f = map_call(s, image_size, kw)
    by_cause = dg.check_overflow(label, f(*s.map_args).overflow, ok)
    notes = ([f"overflow {sum(by_cause)} by cause {by_cause}"] if ok else [])
    notes += [f"raised {r}" for r in raised]
    out[label] = dg.timed(label, f, s.map_args, opts, "; ".join(notes))
  return out


def main(argv=None) -> int:
  p = dg.parser(__doc__, iters=3)
  dg.scene_options(p, gw=8, scene="heavy")
  args = p.parse_args(argv)
  run(dg.prepare(args.scene, args, dg.start(args)), tuple(args.size),
      dg.Opts.of(args))
  return 0


if __name__ == "__main__":
  sys.exit(main())
