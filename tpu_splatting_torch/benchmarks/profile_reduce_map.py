"""``stream_reduce``'s parts and the map's toggles: the counterpart of
``benchmarks/profile_reduce_map.py``.

    python -m tpu_splatting_torch.benchmarks.profile_reduce_map
        [--device cuda|cpu] [--gw 8] [--iters 3] [--n N] [--size W H]

The bench's uniform scene (``bench.prepare_scene``, group width ``--gw``),
its K1 image and the backward's home-major buffer of a ones cotangent.
The reference timed the reduce as the merge kernel alone, then with the
compaction sort, then whole.  On the H100 the slab merge is fused into K2
(``stream_backward``) and stage 2 gathers rows by the map-time
``grad_src`` (``stream_function.reduce_stage2``): no compaction sort.  So
the H100 question is what K2 with its merge, the row gather alone and
the whole of ``stream_reduce`` (gather + duplicate adds) each cost; the
first two labels say so.  Then the map's toggles: the calibrated map,
the duplicate path toggled (the uniform scene calibrates without one, so
it is switched on at ``stream_map``'s defaults, ``wide_cap`` 1024 and
``dup_cap`` 8192), one slab (raised where the scene needs more:
``diagnostics.held_caps``) and no table.
"""

from __future__ import annotations

import sys

import torch

from .. import bench
from ..rasterizer import stream_kernels as sk
from ..rasterizer.stream import stream_map
from ..rasterizer.stream_function import stream_reduce
from . import diagnostics as dg


def map_toggles(s: bench.SceneSetup):
  """[(label, stream_map arguments, note)]: the reference's map labels."""
  dup = ({"wide_cap": 0, "dup_cap": 0} if s.caps["dup_cap"] else
         {"wide_cap": 1024, "dup_cap": 8192})
  out = [("map full", dict(s.caps), "")]
  out.append(("map dup0", {**s.caps, **dup},
              "" if s.caps["dup_cap"] else
              "restated: the scene calibrates without the duplicate path "
              "(dup_cap 0); toggled on at wide_cap 1024, dup_cap 8192"))
  kw, raised = dg.held_caps(s.caps, {"num_slabs": 1}, s.cal)
  out.append(("map slabs1", kw, "; ".join(f"raised {r}" for r in raised)))
  out.append(("map notable", {**s.caps, "build_table": False}, ""))
  return out


def run(s: bench.SceneSetup, image_size, opts: dg.Opts) -> dict:
  m, cfg = s.mapping, s.config
  img = sk.stream_forward(m, cfg)
  gimg = torch.ones_like(img)
  gout = sk.stream_backward(m, img, gimg, cfg)
  out = {"reduce merge-kernel": dg.timed(
      "reduce merge-kernel", lambda mm, i, g: sk.stream_backward(mm, i, g, cfg),
      (m, img, gimg), opts, "restated: the slab merge is fused into K2 "
      "(stream_backward); this is K2 with it")}
  out["reduce +compact-sort"] = dg.timed(
      "reduce +compact-sort", lambda g, idx: g[idx],
      (gout, m.grad_src.long()), opts, "restated: no compaction sort on "
      "the H100; stage 2's row gather by the map-time grad_src alone")
  out["reduce full"] = dg.timed("reduce full", stream_reduce, (gout, m),
                                opts)
  for label, kw, note in map_toggles(s):
    f = (lambda kw: lambda p, d, f_: stream_map(p, d, f_, image_size, cfg,
                                                **kw))(kw)
    dg.check_overflow(label, f(*s.map_args).overflow)
    out[label] = dg.timed(label, f, s.map_args, opts, note)
  return out


def main(argv=None) -> int:
  p = dg.parser(__doc__, iters=3)
  dg.scene_options(p, gw=8)
  args = p.parse_args(argv)
  run(dg.prepare("uniform", args, dg.start(args)), tuple(args.size),
      dg.Opts.of(args))
  return 0


if __name__ == "__main__":
  sys.exit(main())
