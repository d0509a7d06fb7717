"""The sorted pipeline stage by stage: the counterpart of
``benchmarks/profile_stages.py``.

    python -m tpu_splatting_torch.benchmarks.profile_stages
        [--device cuda|cpu] [--n 1000000] [--width 1024] [--height 768]
        [--chunk 128] [--scale 4.0] [--max-overlaps M] [--iters 5]

``bench_components.synthetic_2d`` splats mapped by ``map_to_tiles`` (the
sorted payload riding the sort), then each stage alone, as the reference
timed them: the mapper, the forward kernel (K4), the backward kernel (K5)
on a ones cotangent, the reduce's point-id sort alone, K7
(``layout.segment_sum_sorted``, reading its rows through the sort's
order) alone, both (``reduce_chunked_to_points``), ``rasterize_with_tiles``
forward, its forward + backward of sum(image^2) + sum(weight), and the
map with that forward + backward.  The H100 question is the reference's:
which stage of the sorted pipeline holds the time?  The capacities are
``calibrate_mapper``'s unless ``--max-overlaps`` is given (the
reference's 1 << 23 for these splats leaves ``big_tile_window`` unsized,
ROADMAP F19); a mapping that drops overlaps raises.  The reference's
``--depth16`` is not kept: the port's mapper orders small splats by their
f32 depth either way.
"""

from __future__ import annotations

import sys

import torch

from ..mapper.tile_mapper import map_to_tiles, tile_shape
from ..rasterizer import kernels
from ..rasterizer.function import (_kernel_inputs, _pid_chunked,
                                   rasterize_with_tiles,
                                   reduce_chunked_to_points, sort_point_ids)
from ..rasterizer.layout import segment_sum_sorted
from . import diagnostics as dg
from .bench_components import RasterizerSetup, rasterizer_setup


def run(s: RasterizerSetup, opts: dg.Opts) -> dict:
  m, cfg, size = s.mapping, s.config, s.image_size
  tw, th = tile_shape(size, cfg.tile_size)
  nt, n = tw * th, s.packed.shape[0]
  print(f"n={n} tiles={nt} chunks={m.num_chunks} "
        f"overlaps={int(m.chunk_cnt.sum())} overflow={int(m.num_overflow)}",
        flush=True)
  map_f = lambda p, d, f: map_to_tiles(p, d, size, cfg,
                                       max_overlaps=s.max_overlaps,
                                       features=f)
  out = {"map_to_tiles": dg.timed("map_to_tiles", map_f,
                                   (s.packed, s.depth, s.feats), opts)}
  rows, src, cnt = _kernel_inputs(m, s.packed, s.feats)
  ct = m.chunk_to_tile
  fwd = lambda r: kernels.forward(r, src, cnt, ct, cfg, nt, tw)
  out["fwd_kernel"] = dg.timed("fwd_kernel", fwd, (rows,), opts)
  img, _ = fwd(rows)
  gimg = torch.ones_like(img)
  bwd = lambda r, i, g: kernels.backward(r, i, g, src, cnt, ct, cfg, nt, tw)
  out["bwd_kernel"] = dg.timed("bwd_kernel", bwd, (rows, img, gimg), opts)
  gout = bwd(rows, img, gimg)
  pid = _pid_chunked(m)
  out["reduce_sort_only"] = dg.timed(
      "reduce_sort_only", sort_point_ids, (pid,), opts,
      "the point-id sort of the reduce (torch.sort, stable)")
  order = sort_point_ids(pid)
  out["reduce_kernel_only"] = dg.timed(
      "reduce_kernel_only", lambda g, o: segment_sum_sorted(
          g, o.ids, n, order=o.order), (gout, order), opts,
      "K7 through the sort's order")
  out["sort_reduce"] = dg.timed(
      "sort_reduce", lambda g, p: reduce_chunked_to_points(
          g, sort_point_ids(p), n), (gout, pid), opts)
  out["full_forward"] = dg.timed(
      "full_forward", lambda p, f: rasterize_with_tiles(p, f, m, size, cfg),
      (s.packed, s.feats), opts)

  def fwd_bwd(p, f, mm):
    p = p.detach().requires_grad_(True)
    f = f.detach().requires_grad_(True)
    o = rasterize_with_tiles(p, f, mm, size, cfg)
    return torch.autograd.grad((o.image ** 2).sum() + o.image_weight.sum(),
                               (p, f))

  out["full_fwd_bwd"] = dg.timed("full_fwd_bwd", fwd_bwd,
                                 (s.packed, s.feats, m), opts)
  out["e2e_map_fwd_bwd"] = dg.timed(
      "e2e_map_fwd_bwd", lambda p, d, f: fwd_bwd(p, f, map_f(p, d, f)),
      (s.packed, s.depth, s.feats), opts)
  return out


def main(argv=None) -> int:
  p = dg.parser(__doc__, iters=5)
  p.add_argument("--n", type=int, default=1_000_000)
  p.add_argument("--width", type=int, default=1024)
  p.add_argument("--height", type=int, default=768)
  p.add_argument("--chunk", type=int, default=128)
  p.add_argument("--scale", type=float, default=4.0)
  p.add_argument("--max-overlaps", type=int, default=None)
  args = p.parse_args(argv)
  dev = dg.start(args)
  s = rasterizer_setup(args.n, (args.width, args.height), args.max_overlaps,
                       args.chunk, dev, args.scale)
  run(s, dg.Opts.of(args))
  return 0


if __name__ == "__main__":
  sys.exit(main())
