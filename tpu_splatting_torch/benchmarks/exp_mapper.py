"""``map_to_tiles`` by stage: the counterpart of ``benchmarks/exp_mapper.py``.

    python -m tpu_splatting_torch.benchmarks.exp_mapper [--device cuda|cpu]
        [--n 1000000] [--max-overlaps 8388608] [--iters 5]

``bench_components.synthetic_2d`` splats (scale 4) at 1024x768, tile 16,
and the sorted mapper's stages as the reference composed them, each
alone, from the port's ``mapper.tile_mapper`` pieces: the candidate hits
of the small splats (``_obb_axes``, ``_tile_bounds``,
``_candidate_hits``), the indices of the big splats, the 32-bit sort keys
(tile << 16 | depth16), the key sort carrying the point ids, the same
sort carrying the ten payload columns, each tile's range of the sorted
list (``searchsorted``) and the chunk fills (``_marker_fill``).  The H100
question: the sorted forward up to the mapping takes 15.4-15.8 ms of a
training step (``chip_smoke.py`` phase 6); which stage holds it?  Torch
has no fixed-size ``nonzero``: the big splats' indices come from
``torch.nonzero``, which waits for the device, and the line says so.
The two sorts are ``torch.sort`` of the keys (stable) and a gather of the
carried columns by its permutation.
"""

from __future__ import annotations

import sys

import torch

from ..data_types import RasterConfig
from ..lib import gaussian2d as g2d
from ..mapper import tile_mapper as tm
from . import diagnostics as dg
from .bench_components import synthetic_2d

IMAGE_SIZE = (1024, 768)


def run(n, max_overlaps, image_size, dev, opts: dg.Opts) -> dict:
  packed, depth, feats = synthetic_2d(n, image_size, scale_factor=4.0,
                                      device=dev)
  config = RasterConfig()
  ts = config.tile_size
  tw, th = tm.tile_shape(image_size, ts)
  num_tiles = tw * th
  padded = tm.pad_to_tile(image_size, ts)
  w_small = config.tile_window

  def stage_hits(gaussians, d):
    mean, axis, sigma, alpha = g2d.unpack_g2d(gaussians)
    gscale = g2d.gaussian_scale(alpha, config.alpha_threshold)
    valid = (alpha > config.alpha_threshold) & (d > 0) & (gscale > 0)
    u1, u2, e1, e2 = tm._obb_axes(axis, sigma, gscale, ts)
    min_tile, max_tile = tm._tile_bounds(mean, axis, sigma, gscale, padded,
                                         ts)
    span = max_tile - min_tile
    is_big = valid & torch.any(span > w_small, -1)
    hit, tid = tm._candidate_hits(mean, u1, u2, e1, e2, min_tile, span,
                                  valid & ~is_big, w_small, ts, tw)
    return hit, tid, is_big

  out = {"hits": dg.timed("hits", lambda g, d: stage_hits(g, d)[0].sum(),
                          (packed, depth), opts)}
  hit, tid, is_big = stage_hits(packed, depth)
  print(f"hits: {int(hit.sum())} big: {int(is_big.sum())}", flush=True)
  out["nonzero_big"] = dg.timed(
      "nonzero_big", lambda b: torch.nonzero(b)[:, 0], (is_big,), opts,
      "torch.nonzero: no fixed size, the host waits for the count")
  pid_col = torch.arange(n, device=dev)[:, None]

  def make_key(h, t, d):
    d16 = (torch.clamp(d[:, None], 0.0, 1.0) * 65535.0).to(torch.int64)
    key = torch.where(h, (t << 16) | d16, 0xFFFFFFFF)
    pid = torch.where(h, pid_col, n).expand(t.shape)
    return key.reshape(-1), pid.reshape(-1)

  out["keys"] = dg.timed("keys", lambda h, t, d: make_key(h, t, d)[0],
                         (hit, tid, depth), opts)
  key, pid = make_key(hit, tid, depth)

  def sort_2op(k, p):
    s = torch.sort(k, stable=True)
    return s.values, p[s.indices]

  out["sort_2op"] = dg.timed("sort_2op", sort_2op, (key, pid), opts)
  cols = torch.cat([packed, feats], 1)[:, None, :].expand(
      n, tid.shape[1], 10).reshape(-1, 10)

  def sort_12op(k, p, c):
    s = torch.sort(k, stable=True)
    return s.values, p[s.indices], c[s.indices]

  out["sort_12op"] = dg.timed("sort_12op", sort_12op, (key, pid, cols), opts)
  sorted_tile = (sort_2op(key, pid)[0][:max_overlaps] >> 16)

  def stage_ranges(st):
    tids = torch.arange(num_tiles, device=dev)
    return (torch.searchsorted(st, tids), torch.searchsorted(st, tids,
                                                             right=True))

  out["ranges_searchsorted"] = dg.timed("ranges_searchsorted", stage_ranges,
                                        (sorted_tile,), opts)
  starts, ends = stage_ranges(sorted_tile)

  def stage_chunks(s, e):
    g = config.chunk_size
    aligned = torch.clamp((e - s + g - 1) // g, min=1)
    offsets = torch.cat([aligned.new_zeros(1), torch.cumsum(aligned, 0)])
    k_chunks = max_overlaps // g + num_tiles
    tids = torch.arange(num_tiles, device=dev)
    return (tm._marker_fill(tids, offsets[:num_tiles], k_chunks),
            tm._marker_fill(offsets[:num_tiles], offsets[:num_tiles],
                            k_chunks),
            tm._marker_fill(s, offsets[:num_tiles], k_chunks),
            tm._marker_fill(e, offsets[:num_tiles], k_chunks))

  out["chunk_fills"] = dg.timed("chunk_fills", stage_chunks, (starts, ends),
                                opts)
  return out


def main(argv=None) -> int:
  p = dg.parser(__doc__, iters=5)
  p.add_argument("--n", type=int, default=1_000_000)
  p.add_argument("--max-overlaps", type=int, default=1 << 23)
  p.add_argument("--size", type=int, nargs=2, default=IMAGE_SIZE,
                 metavar=("W", "H"), help="image size")
  args = p.parse_args(argv)
  run(args.n, args.max_overlaps, tuple(args.size), dg.start(args),
      dg.Opts.of(args))
  return 0


if __name__ == "__main__":
  sys.exit(main())
