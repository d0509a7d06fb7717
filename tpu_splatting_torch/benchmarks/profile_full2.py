"""The raster step under two capacity sets: the counterpart of
``benchmarks/profile_full2.py``.

    python -m tpu_splatting_torch.benchmarks.profile_full2 [--device cuda|cpu]
        [--gw 8] [--iters 3] [--n N] [--size W H]

The reference asked whether the full renderer's gap to the 2D frame on
the TPU was its capacities (the projected scene calibrated to more slabs
and a larger w_max, each of which doubled the TPU kernels' mask matmuls
and window copies).  The H100 question: what do the two capacity sets
cost the stream raster step on this card?  The bench's 2D protocol step
(``bench.make_scene_step``: the map, then the forward + backward of the
tiled loss with the heuristics) is timed on the uniform 2D scene and on
the same splats lifted to 3D and projected, each under ``caps_2d`` (the
port's calibration of the 2D scene, ``bench.calibrate_scene``) and under
``caps_full`` (of the projected scene, ``bench.calibrate_full``), both
through the bench's cache.  The reference timed a pairing even where it
dropped rows; here a capacity set that cannot hold the scene is replaced
by the larger of the two sets, field by field, and the line says so.
"""

from __future__ import annotations

import dataclasses
import sys

import torch

from .. import bench
from ..perspective.projection import ndc_depth, project_to_image
from ..rasterizer.stream import stream_map
from . import diagnostics as dg

LABELS = (("2d-scene @ caps_2d", "2d", "caps_2d"),
          ("2d-scene @ caps_full", "2d", "caps_full"),
          ("projected @ caps_full", "projected", "caps_full"),
          ("projected @ caps_2d", "projected", "caps_2d"))
CAP_FIELDS = (*bench.MAP_KEYS, "big_tile_window")


def capacity_sets(packed, depth, feats, gw, image_size, dev):
  """({"2d": (packed, depth, feats), "projected": ...} on ``dev``,
  {"caps_2d": cal, "caps_full": cal})."""
  p, d, f = bench.to_device(dev, packed, depth, feats)
  g3d, cam, cal_full = bench.lift_and_calibrate("uniform", packed, depth,
                                                feats, gw, image_size, dev)
  cal_2d = bench.calibrate_scene("uniform", p, d, f, image_size, gw)
  with torch.no_grad():
    g2, pd, _ = project_to_image(g3d, cam, bench._trainer_config(gw))
    nd = torch.where(pd > 0, ndc_depth(pd, cam.near_plane, cam.far_plane),
                     0.0).reshape(-1)
  return ({"2d": (p, d, f), "projected": (g2, nd, f)},
          {"caps_2d": cal_2d, "caps_full": cal_full})


def held(scene, cal, other, image_size, gw):
  """(capacities, note): ``cal``'s, or the larger of ``cal`` and
  ``other`` field by field where ``cal``'s drop rows of ``scene``."""
  def maps(c):
    cfg = dataclasses.replace(bench._trainer_config(gw),
                              big_tile_window=c["big_tile_window"])
    return stream_map(*scene, image_size, cfg, group_width=gw,
                      **{k: c[k] for k in bench.MAP_KEYS}).overflow
  by_cause = maps(cal).tolist()
  if not sum(by_cause):
    return cal, ""
  both = {k: max(cal[k], other[k]) for k in CAP_FIELDS}
  dg.check_overflow("the larger capacities", maps(both))
  return both, (f"restated: these capacities drop {sum(by_cause)} rows "
                f"(by cause {by_cause}); timed at the larger of both sets")


def run(scenes, cals, gw, image_size, opts: dg.Opts) -> dict:
  out = {}
  dev = scenes["2d"][0].device
  tgt, mask = bench.loss_target(image_size,
                                bench._trainer_config(gw).tile_size, dev)
  for label, scene, caps in LABELS:
    other = "caps_full" if caps == "caps_2d" else "caps_2d"
    cal, note = held(scenes[scene], cals[caps], cals[other], image_size, gw)
    cfg = dataclasses.replace(bench._trainer_config(gw),
                              big_tile_window=cal["big_tile_window"])
    map_f, fwd_bwd = bench.make_scene_step(
        image_size, cfg, {**{k: cal[k] for k in bench.MAP_KEYS},
                          "group_width": gw})
    p, d, f = scenes[scene]
    m = map_f(p, d, f)
    out[label] = dg.timed(label, fwd_bwd, (p, f, tgt, mask, m), opts, note)
  return out


def main(argv=None) -> int:
  p = dg.parser(__doc__, iters=3)
  dg.scene_options(p, gw=8)
  args = p.parse_args(argv)
  dev = dg.start(args)
  size = tuple(args.size)
  scenes, cals = capacity_sets(*bench.scene_arrays("uniform", args.n, size),
                               args.gw, size, dev)
  run(scenes, cals, args.gw, size, dg.Opts.of(args))
  return 0


if __name__ == "__main__":
  sys.exit(main())
