"""Tile-stream mapping: home-sorted points, window tables, capacities.

Counterpart of ``tpu_splatting/rasterizer/stream.py`` (see its module
docstring for the design).  ``stream_map`` builds the same
``StreamMapping``, field for field: on a scene without sort-key ties the
table and every integer field equal the reference's.  What differs is how,
not what:

* sort keys are 32-bit layouts held in int64 (sentinel ``0xFFFFFFFF``),
  and the one N-sized sort is stable on (key, pid);
* the TPU's one-hot and triangular matmuls (exact integer gathers and
  prefix sums on the MXU) are plain ``gather`` / ``cumsum``;
* ``searchsorted`` does the descriptor compaction;
* gathers and scatters mask out-of-range indices explicitly where the
  reference relies on JAX's clamping or ``mode="drop"``;
* on the card the window descriptors are one hand-written kernel,
  ``csrc/stream_map.cu`` (``stream_kernels.stream_descriptors``); on the
  CPU its plain twin, ``stream_descriptors_reference``, builds each
  group's band-local edge slices and runs the reference's descriptor
  pipeline (``_desc_pipeline``) over group chunks in Python.

Everything else here is plain torch and runs on the inputs' device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from .. import trace
from ..data_types import RasterConfig
from ..lib import gaussian2d as g2d
from ..mapper.tile_mapper import pad_to_tile, tile_shape

_I = torch.int64
SENTINEL = 0xFFFFFFFF


@dataclass
class StreamMapping:
  """Static-shape stream mapping; fields and meaning as the reference's
  ``StreamMapping`` (``tpu_splatting/rasterizer/stream.py``).

  table: (N_pad / RPB, RPB * W_PAD) f32 — home-sorted rows, a plain
    row-major (N_pad, W_PAD) array viewed RPB rows per packed row:
    [gaussian(7), features(F), depth rank (by value), zeros...].
  pid_order: (N_pad,) i32 — pid of each sorted table row.
  desc: (GROUPS, 1, GW*S*W_MAX*4) i32 — window descriptors per (tile in
    group, slab): [lo_flat, len, gbuf_dst, class(b*3+k)] x W_MAX,
    nonempty first.  lo_flat indexes the 3-band strip space in rows
    (band b starts at b * (2 * strip_cap + STRIP_SLACK)).
  strip_blk: (GROUPS, 3) i32 — strip_cap-block index of each band strip.
  run_starts: (T+1,) i32 — first sorted row of each home's run.
  num_overflow: () i32 — rows dropped by capacity clamps.
  overflow: (5,) i32 — the same split by cause (OVERFLOW_CAUSES).
  grad_src: (N,) i32 — per point, its home-major gradient-buffer row.
  dup_src / dup_pid: (dup_cap,) i32 — gradient rows of duplicate rows and
    the point each belongs to (N marks unused).
  """
  table: torch.Tensor
  pid_order: torch.Tensor
  desc: torch.Tensor
  strip_blk: torch.Tensor
  run_starts: torch.Tensor
  num_overflow: torch.Tensor
  overflow: torch.Tensor
  grad_src: torch.Tensor
  dup_src: torch.Tensor
  dup_pid: torch.Tensor

  # static metadata
  num_points: int
  num_tiles: int
  tiles_wide: int
  tiles_high: int
  feature_size: int
  group_width: int
  num_slabs: int
  strip_cap: int
  slab_cap: int
  w_max: int
  run_cap: int
  dup_cap: int = 0
  depth_bits: int = 14
  rows_per_block: int = 4

  @property
  def num_groups(self) -> int:
    return self.desc.shape[0]

  @property
  def row_width(self) -> int:
    """Scalars per table row: 7 gaussian + F features + depth rank."""
    return 7 + self.feature_size + 1


def rows_per_block_for(row_width: int) -> Tuple[int, int]:
  """(rows per packed row, padded scalars per row): the row stride is the
  smallest power of two >= row_width (at least 32), packed to 128 lanes."""
  w_pad = 32
  while w_pad < row_width:
    w_pad *= 2
  return max(1, 128 // w_pad), w_pad


def _depth16(d: torch.Tensor) -> torch.Tensor:
  return torch.clamp(d * 65535.0, 0.0, 65535.0).to(_I)


def depth_bits_for(num_tiles: int) -> int:
  """Key layout home | ycls(2) | xcls(2) | depth in 32 bits: 14 depth
  bits up to 16,383 tiles, 12 beyond (16-bit home id)."""
  if num_tiles < (1 << 14):
    return 14
  assert num_tiles < (1 << 16), f"tile count {num_tiles} exceeds 16-bit id"
  return 12


# Reach classes (both axes): [C=0, C+pos=1, C+both=2, C+neg=3].
CLASS_RANGES = ((1, 3), (0, 4), (2, 4))

# strip slack rows (the reference kernels' largest tiered copy); window
# chunking and the lo_flat band stride are defined by it
STRIP_SLACK = 512

OVERFLOW_CAUSES = ("wide", "strip", "slab", "run", "window")

# the 64 fetch windows (band b, home k, ycls, xcls), in key order
_WLIST = tuple(
    (b, k, yc, xc)
    for b in range(3) for k in range(3)
    for yc in range(*CLASS_RANGES[b]) for xc in range(*CLASS_RANGES[k]))


def _tiles_of(x, ts, max_tile):
  t = torch.floor(x / ts).to(_I)
  return torch.minimum(torch.clamp(t, min=0), max_tile)


def _group_bands(tw, th, gw, dev):
  """Each tile group's first tile column gx ((G,) int64) and its three
  bands gy - 1 .. gy + 1 ((G, 3) int64) with their in-image mask."""
  groups_x = tw // gw
  g = torch.arange(th * groups_x, dtype=_I, device=dev)
  gx = (g % groups_x) * gw
  band = (g // groups_x)[:, None] + torch.arange(3, dtype=_I,
                                                 device=dev)[None, :] - 1
  return gx, band, (band >= 0) & (band < th)


def _desc_pipeline(local_c, gx_c, *, gw, tw, s_edges, per_home, slab_cap,
                   w_max, run_cap, rpb, strip_cap):
  """Window descriptors of one chunk of groups (reference
  ``desc_pipeline``): per-window cell edges, the greedy slab plan,
  window merge, run clamp, chunking and compaction.  Returns
  (desc (Gc, 1, gw*S*w_max*4), [run, chunk, window, slab] overflow)."""
  dev = local_c.device
  g_c, _, lw = local_c.shape
  n_w = len(_WLIST)
  wb = torch.tensor([w[0] for w in _WLIST], dtype=_I, device=dev)
  wk = torch.tensor([w[1] for w in _WLIST], dtype=_I, device=dev)
  wc0 = torch.tensor([w[2] * 4 + w[3] for w in _WLIST], dtype=_I, device=dev)
  bks = wb * 3 + wk
  i_t = torch.arange(gw, dtype=_I, device=dev)
  flat = local_c.reshape(g_c, 3 * lw)

  # cell edges of window w for tile i: local[b, (k+i)*per_home + c0*S + s]
  # for s in 0..S (the end edge is the next flat entry)
  home_i = wk[:, None] + i_t[None, :]                        # (n_w, gw)
  idx = (wb[:, None, None] * lw + home_i[:, :, None] * per_home
         + wc0[:, None, None] * s_edges
         + torch.arange(s_edges + 1, dtype=_I, device=dev))
  ce = flat[:, idx.reshape(-1)].view(g_c, n_w, gw, s_edges + 1)
  ce = ce.permute(0, 2, 1, 3)                       # (G, gw, n_w, S+1)
  run0 = flat[:, (wb[:, None] * lw + home_i * per_home).reshape(-1)]
  run0 = run0.view(g_c, n_w, gw).permute(0, 2, 1)           # (G, gw, n_w)
  dst_bias = (i_t[:, None] + wk[None, :]) * run_cap - run0
  hx = gx_c[:, None, None] + i_t[None, :, None] - 1 + wk[None, None, :]
  hvalid = (hx >= 0) & (hx < tw)                             # (G, gw, n_w)

  counts = torch.where(hvalid[..., None], ce[..., 1:] - ce[..., :-1],
                       0).sum(2)

  # greedy packing of adjacent depth cells into slabs
  pad_reserve = rpb * 16
  cc = counts.reshape(-1, s_edges)
  acc = cc[:, 0]
  bounds = [torch.zeros_like(acc)]
  for cell in range(1, s_edges):
    cut = acc + cc[:, cell] > slab_cap - pad_reserve
    bounds.append(torch.where(cut, cell, 0))
    acc = torch.where(cut, cc[:, cell], acc + cc[:, cell])
  bvec = torch.stack(bounds, -1)
  big = 10 ** 6
  srt = torch.sort(torch.where(bvec > 0, bvec, big), -1).values
  compacted = torch.where(srt < big, srt, s_edges)
  plan = torch.cat([torch.zeros_like(cc[:, :1]), compacted[:, :s_edges - 1],
                    torch.full_like(cc[:, :1], s_edges)], -1)
  plan = plan.view(g_c, gw, 1, s_edges + 1).expand(g_c, gw, n_w, s_edges + 1)

  w_lo = torch.gather(ce, 3, plan[..., :s_edges].contiguous())
  w_hi = torch.gather(ce, 3, plan[..., 1:].contiguous())
  w_len = torch.where(hvalid[..., None], torch.clamp(w_hi - w_lo, min=0), 0)
  w_dst = w_lo + dst_bias[..., None]
  scratch_stride = 2 * strip_cap + STRIP_SLACK
  w_lof = w_lo + (wb * scratch_stride)[None, None, :, None]

  # (G, gw, n_w, S) -> (G, gw, S, n_w)
  w_lof = w_lof.permute(0, 1, 3, 2)
  w_len = w_len.permute(0, 1, 3, 2)
  w_dst = w_dst.permute(0, 1, 3, 2)

  # merge adjacent windows of one (b, k) whose strip intervals abut
  same_bk = torch.zeros(n_w, dtype=torch.bool, device=dev)
  same_bk[1:] = bks[1:] == bks[:-1]

  def prev(a):
    return torch.nn.functional.pad(a[..., :-1], (1, 0))

  cont = same_bk & (w_lof == prev(w_lof) + prev(w_len))
  pref_in = torch.cumsum(w_len, -1)
  pref_ex = pref_in - w_len
  # prefix value at each chain's start: boundaries carry pref_ex, a
  # log-step max fills forward (pref_ex is nondecreasing)
  seg_base = torch.where(cont, -1, pref_ex)
  d = 1
  while d < n_w:
    seg_base = torch.maximum(seg_base, torch.nn.functional.pad(
        seg_base[..., :-d], (d, 0), value=-1))
    d *= 2
  rel = pref_ex - seg_base
  ended = torch.cat([~cont[..., 1:], torch.ones_like(cont[..., :1])], -1)
  w_lof = torch.where(ended, w_lof - rel, 0)
  w_dst = torch.where(ended, w_dst - rel, 0)
  w_len = torch.where(ended, pref_in - seg_base, 0)

  # run_cap clamp
  run_hi = (wk[None, None, None, :] + i_t[None, :, None, None] + 1) * run_cap
  len_run = torch.clamp(run_hi - w_dst, min=0)
  run_over = torch.clamp(w_len - len_run, min=0).sum()
  w_len = torch.minimum(w_len, len_run)

  # chunk long windows into <= STRIP_SLACK - rpb rows
  chunk = STRIP_SLACK - rpb
  if slab_cap <= 2048:
    cf = max(1, -(-slab_cap // chunk))
    chunk_over = torch.clamp(w_len - cf * chunk, min=0).sum()
    w_len = torch.clamp(w_len, max=cf * chunk)
    pieces = (w_len + chunk - 1) // chunk
  else:
    chunk_over = torch.zeros((), dtype=_I, device=dev)
    pieces = (w_len > 0).to(_I)

  # compaction: output slot o holds the piece of rank o (window k owns
  # ranks [cum_ex[k], cum_in[k]))
  cum_in = torch.cumsum(pieces, -1).contiguous()
  cum_ex = cum_in - pieces
  ob = torch.arange(w_max, dtype=_I, device=dev)
  k_of = torch.searchsorted(
      cum_in, ob.expand(cum_in.shape[:-1] + (w_max,)).contiguous(),
      right=True)
  has = k_of < n_w
  kc = torch.clamp(k_of, max=n_w - 1)
  step = (ob - torch.gather(cum_ex, -1, kc)) * chunk
  d_len = torch.where(
      has, torch.clamp(torch.gather(w_len, -1, kc) - step, 0, chunk), 0)
  d_lo = torch.where(has, torch.gather(w_lof, -1, kc) + step, 0)
  d_dst = torch.where(has, torch.gather(w_dst, -1, kc) + step, 0)
  d_bk = torch.where(has, bks[kc], 0)
  win_over = w_len.sum() - d_len.sum()

  desc = torch.stack([d_lo, d_len, d_dst, d_bk], -1)
  desc = desc.reshape(g_c, 1, gw * s_edges * w_max * 4)

  # quantized slab accounting (window copies occupy whole packed rows)
  head_q = d_lo % rpb
  len_q = torch.where(d_len > 0, ((head_q + d_len + rpb - 1) // rpb) * rpb,
                      0)
  cur_q = torch.cumsum(len_q, -1) - len_q
  avail_q = torch.clamp(slab_cap - (cur_q + head_q), min=0)
  slab_over = torch.clamp(d_len - avail_q, min=0).sum()
  return desc, torch.stack([run_over, chunk_over, win_over, slab_over])


def stream_descriptors_reference(edges_all, strip_blk, *, tiles_wide,
                                 tiles_high, group_width, num_slabs,
                                 strip_cap, slab_cap, w_max, run_cap,
                                 rows_per_block):
  """Plain twin of ``stream_kernels.stream_descriptors``: the window
  descriptors of every tile group from the cell-edge table ``edges_all``
  (tiles * 16 * S + 1 int64) and the groups' strip blocks ``strip_blk``
  ((G, 3) int64).  Each group's band-local edges (homes x0-1 .. x0+gw of
  its three band strips, relative to the strip's block and clamped to
  [0, 2 * strip_cap]), then ``_desc_pipeline`` over group chunks.
  Returns (desc int32 (G, 1, gw*S*w_max*4), int64 [run, chunk, window,
  slab] overflow)."""
  dev = edges_all.device
  tw, th, gw, s_edges = tiles_wide, tiles_high, group_width, num_slabs
  num_tiles = tw * th
  gx, band, band_ok = _group_bands(tw, th, gw, dev)
  n_groups = gx.shape[0]
  tbl_homes = gw + 2
  per_home = 16 * s_edges
  k_tot = num_tiles * per_home
  hh = gx[:, None, None] - 1 + torch.arange(
      tbl_homes + 1, dtype=_I, device=dev)[None, None, :]
  hid = band[:, :, None] * tw + torch.clamp(hh, 0, tw)          # (G, 3, H+1)
  hidc = torch.clamp(hid, 0, num_tiles)
  edges_grid = torch.cat(
      [edges_all[:k_tot].view(num_tiles, per_home),
       edges_all[k_tot].expand(1, per_home)], 0)
  evals = torch.cat(
      [edges_grid[hidc[:, :, :tbl_homes]].reshape(
          n_groups, 3, tbl_homes * per_home),
       edges_grid[hidc[:, :, -1], 0][:, :, None]], -1)
  local = evals - (strip_blk * strip_cap)[:, :, None]
  local = torch.clamp(torch.where(band_ok[:, :, None], local, 0),
                      0, 2 * strip_cap)
  del evals

  # group chunks bound the (Gc, gw, 64, S+1) intermediates
  gchunk = max(1, (1 << 22) // (gw * len(_WLIST) * (s_edges + 1)))
  descs, overs = [], []
  for g0 in range(0, n_groups, gchunk):
    d, o = _desc_pipeline(
        local[g0:g0 + gchunk], gx[g0:g0 + gchunk], gw=gw, tw=tw,
        s_edges=s_edges, per_home=per_home, slab_cap=slab_cap,
        w_max=w_max, run_cap=run_cap, rpb=rows_per_block,
        strip_cap=strip_cap)
    descs.append(d)
    overs.append(o)
  return torch.cat(descs, 0).to(torch.int32), torch.stack(overs).sum(0)


def stream_map(gaussians: torch.Tensor, depth: torch.Tensor,
               features: torch.Tensor, image_size: Tuple[int, int],
               config: RasterConfig, num_slabs: int = 1,
               strip_cap: int = 4096, slab_cap: int = 512,
               group_width: int = 8, w_max: int = 64, run_cap: int = 256,
               build_table: bool = True, wide_cap: int = 1024,
               dup_cap: int = 8192, depth_bits: int = 0) -> StreamMapping:
  """Build the stream mapping: one N-sized sort + window tables.

  depth: (N,) NDC depth in [0, 1]; <= 0 marks culled points.  Capacities
  are static and overflow is counted (``calibrate_stream`` sizes them);
  ``build_table=False`` builds the descriptors only (calibration).
  """
  with trace.span("map"):
    dev = gaussians.device
    n = gaussians.shape[0]
    f_size = features.shape[1]
    ts = config.tile_size
    tw, th = tile_shape(image_size, ts)
    num_tiles = tw * th
    db = depth_bits or depth_bits_for(num_tiles)
    assert num_tiles < (1 << (28 - db))
    assert tw % group_width == 0, (tw, group_width)
    assert slab_cap <= 2048 or not build_table, (
        f"slab_cap {slab_cap} overflows the 11-bit rank-key slot")
    assert 2 * n + dup_cap < (1 << 30)
    depth = depth.reshape(n)
    zero = torch.zeros((), dtype=_I, device=dev)

    def iota(m):
      return torch.arange(m, dtype=_I, device=dev)

    with trace.span("map.bounds"):
      mean, axis, sigma, alpha = g2d.unpack_g2d(gaussians)
      gscale = g2d.gaussian_scale(alpha, config.alpha_threshold)
      valid = (alpha > config.alpha_threshold) & (depth > 0) & (gscale > 0)

      lower, upper = g2d.ellipse_bounds(
          mean, axis * (sigma[:, 0] * gscale)[:, None],
          g2d.perp(axis) * (sigma[:, 1] * gscale)[:, None])
      padded = pad_to_tile(image_size, ts)
      max_tile = torch.tensor([(padded[0] - 1) // ts, (padded[1] - 1) // ts],
                              dtype=_I, device=dev)
      lo_t = _tiles_of(lower, ts, max_tile)
      hi_t = _tiles_of(upper, ts, max_tile)
      home = _tiles_of(mean, ts, max_tile)

    with trace.span("map.wide_dup"):
      # wide splats (reach beyond +-1 tile of home) get duplicate rows for
      # the span tiles outside their 3x3 core
      reach_ok = torch.all((home - lo_t <= 1) & (hi_t - home <= 1), -1)
      wide = valid & ~reach_ok
      num_wide = wide.sum()
      if dup_cap > 0:
        assert wide_cap > 0
        w_idx = torch.sort(torch.where(wide, iota(n), n)).values[:wide_cap]
        if n < wide_cap:
          w_idx = torch.cat([w_idx, torch.full((wide_cap - n,), n, dtype=_I,
                                               device=dev)])
        present = w_idx < n
        far_over = torch.clamp(num_wide - wide_cap, min=0)

        def gpad(x):
          return torch.cat([x, torch.zeros_like(x[:1])], 0)[w_idx]

        lo_w, hi_w, home_w = gpad(lo_t), gpad(hi_t), gpad(home)
        span_full = hi_w - lo_w + 1
        span_w = torch.clamp(span_full, max=config.big_tile_window)
        clip_over = (torch.any(span_full > span_w, -1) & present).sum()
        cnt_w = torch.where(present, span_w[:, 0] * span_w[:, 1], 0)
        off = torch.cat([zero[None], torch.cumsum(cnt_w, 0)])
        total_dup = off[-1]
        dup_over = torch.clamp(total_dup - dup_cap, min=0)

        # slot -> owning wide splat: ones at each splat's end slot + cumsum
        r = iota(dup_cap)
        ends = off[1:]
        ends = ends[ends < dup_cap]
        seg = torch.zeros(dup_cap, dtype=_I, device=dev).index_add_(
            0, ends, torch.ones_like(ends))
        w_of = torch.clamp(torch.cumsum(seg, 0), 0, wide_cap - 1)
        depth_ext = torch.cat([depth, torch.zeros_like(depth[:1])])
        d16_w = _depth16(depth_ext[w_idx]) >> (16 - db)
        packed_w = torch.stack(
            [off[:wide_cap], lo_w[:, 0], lo_w[:, 1],
             torch.clamp(span_w[:, 0], min=1), home_w[:, 0], home_w[:, 1],
             w_idx, d16_w], -1)
        rw = packed_w[w_of]
        l = r - rw[:, 0]
        tx = rw[:, 1] + torch.remainder(l, rw[:, 3])
        ty = rw[:, 2] + torch.div(l, rw[:, 3], rounding_mode="floor")
        in_core = ((torch.abs(tx - rw[:, 4]) <= 1)
                   & (torch.abs(ty - rw[:, 5]) <= 1))
        dup_ok = (r < total_dup) & ~in_core & (rw[:, 6] < n)
        dup_src = torch.where(dup_ok, rw[:, 6], n)
        key_dup = torch.where(dup_ok, ((ty * tw + tx) << (db + 4)) | rw[:, 7],
                              SENTINEL)
        pid_dup = torch.where(dup_ok, dup_src + n, 2 * n + r)
        num_far = far_over + clip_over + dup_over
        trace.count(wide=num_wide, dup_rows=dup_ok.sum)
      else:
        num_far = num_wide
        trace.count(wide=num_wide, dup_rows=0)

      def reach_cls(i):
        neg = lo_t[:, i] < home[:, i]
        pos = hi_t[:, i] > home[:, i]
        return torch.where(neg & pos, 2, torch.where(neg, 3,
                                                     torch.where(pos, 1, 0)))

      home_id = home[:, 1] * tw + home[:, 0]
      key = ((home_id << (db + 4)) | (reach_cls(1) << (db + 2))
             | (reach_cls(0) << db) | (_depth16(depth) >> (16 - db)))
      key = torch.where(valid, key, SENTINEL)

    with trace.span("map.sort"):
      pid = iota(n)
      w_row = 7 + f_size + 1
      rpb, w_pad = rows_per_block_for(w_row)
      assert slab_cap % rpb == 0 and strip_cap % rpb == 0
      n_rows = n + dup_cap
      if dup_cap > 0:
        key_all = torch.cat([key, key_dup])
        pid_all = torch.cat([pid, pid_dup])
      else:
        key_all, pid_all = key, pid
      if build_table:
        # stable on (key, pid): distinct combined keys, one sort
        perm = torch.sort((key_all << 30) | pid_all).indices
        skey = key_all[perm]
        spid = pid_all[perm]
        src_all = pid
        if dup_cap > 0:
          src_all = torch.cat([pid, dup_src])
        gf = torch.cat([gaussians, features.to(gaussians.dtype)], 1)
        gf_ext = torch.cat([gf, torch.zeros_like(gf[:1])], 0)
        n_pad = ((n_rows + strip_cap - 1) // strip_cap + 2) * strip_cap
        table = torch.zeros((n_pad, w_pad), dtype=gaussians.dtype, device=dev)
        table[:n_rows, :7 + f_size] = gf_ext[torch.clamp(src_all[perm], max=n)]
        # the depth rank rides the float table by value (exact below 2^24)
        table[:n_rows, 7 + f_size] = (skey & ((1 << db) - 1)).to(table.dtype)
        table[n_rows:, 7 + f_size] = float((1 << db) - 1)
        table = table.view(n_pad // rpb, rpb * w_pad)
        pid_order = torch.cat([spid, torch.full((n_pad - n_rows,),
                                                2 * n + dup_cap, dtype=_I,
                                                device=dev)]).to(torch.int32)
      else:
        skey = torch.sort(key_all).values
        table = torch.zeros((1, rpb * w_pad), dtype=gaussians.dtype, device=dev)
        pid_order = torch.zeros((0,), dtype=torch.int32, device=dev)

    with trace.span("map.edges"):
      # ---- class/cell edge table ------------------------------------------
      # edges by counting: flat cell id of every sorted row, histogram, cumsum;
      # depth cells split at equal quantiles of the valid d14 distribution
      s_edges = num_slabs
      k_tot = num_tiles * 16 * s_edges
      d14_r = skey & ((1 << db) - 1)
      hc_r = skey >> db
      if s_edges > 1:
        dv = _depth16(depth) >> (16 - db)
        dq = torch.sort(torch.where(valid, dv, 0xFFFF)).values
        n_valid = valid.sum()
        qpos = (torch.arange(1, s_edges, dtype=_I, device=dev) * n_valid
                ) // s_edges
        thr = torch.clamp(dq[qpos] + 1, max=(1 << db) - 1)
        cell_r = torch.searchsorted(thr, d14_r, right=True)  # thresholds <= d14
      else:
        cell_r = torch.zeros_like(d14_r)
      f_cell = hc_r * s_edges + cell_r
      f_cell = f_cell[hc_r < num_tiles * 16]
      cnt = torch.bincount(f_cell, minlength=k_tot)
      edges_all = torch.cat([zero[None], torch.cumsum(cnt, 0)])

    with trace.span("map.strips"):
      # ---- per-group strip blocks ------------------------------------------
      gw = group_width
      gx, band, band_ok = _group_bands(tw, th, gw, dev)
      h0 = band * tw + torch.clamp(gx[:, None] - 1, min=0)
      e_idx0 = torch.where(band_ok, h0 * (16 * s_edges), 0)
      start_row = edges_all[e_idx0]
      strip_blk = torch.where(band_ok, start_row // strip_cap, 0)

      # rows of each band strip: homes x0-1 .. x0+gw, clamped to the band's
      # row (out-of-image bands read 0 rows)
      def strip_edge(hh):
        hid = torch.clamp(band * tw + torch.clamp(hh, 0, tw), 0, num_tiles)
        return edges_all[hid * (16 * s_edges)]
      strip_over = torch.clamp(
          strip_edge(gx[:, None] + gw + 1) - strip_edge(gx[:, None] - 1)
          - 2 * strip_cap, min=0)

    with trace.span("map.descriptors"):
      # imported here: stream_kernels imports this module
      from .stream_kernels import stream_descriptors
      desc, over = stream_descriptors(
          edges_all, strip_blk, tiles_wide=tw, tiles_high=th,
          group_width=gw, num_slabs=s_edges, strip_cap=strip_cap,
          slab_cap=slab_cap, w_max=w_max, run_cap=run_cap,
          rows_per_block=rpb)
      run_over, chunk_over, win_over, slab_over = over
      overflow = torch.stack([num_far, strip_over.sum(), slab_over + chunk_over,
                              run_over, win_over])

    with trace.span("map.grad_gather"):
      # ---- map-time gradient gather indices --------------------------------
      run_starts = edges_all[0::16 * s_edges]
      zero_i = torch.zeros((0,), dtype=torch.int32, device=dev)
      if build_table:
        r_rows = num_tiles * run_cap
        home_j = skey >> (db + 4)
        # offset in its home's run (sentinel rows are masked below)
        row_off = iota(n_rows) - run_starts[torch.clamp(home_j, max=num_tiles)]
        ok_row = (skey != SENTINEL) & (row_off < run_cap) & (home_j < num_tiles)
        gout_row = torch.where(
            ok_row, torch.clamp(home_j, 0, num_tiles - 1) * run_cap + row_off,
            r_rows)
        # invert the pid permutation; the duplicates of one splat share the
        # pid src + n, so the sort is stable (they stay in table order)
        order2 = torch.sort(spid, stable=True).indices
        s2k, s2v = spid[order2], gout_row[order2]
        grad_src = s2v[:n].to(torch.int32)
        if dup_cap > 0:
          dup_ok_t = s2k[n:] < 2 * n
          dup_pid = torch.where(dup_ok_t, s2k[n:] - n, n).to(torch.int32)
          dup_src = torch.where(dup_ok_t, s2v[n:], r_rows).to(torch.int32)
        else:
          dup_src = dup_pid = zero_i
      else:
        grad_src = dup_src = dup_pid = zero_i

    overflow = overflow.to(torch.int32)
    return StreamMapping(
        table=table,
        pid_order=pid_order,
        desc=desc,
        strip_blk=strip_blk.to(torch.int32),
        run_starts=run_starts.to(torch.int32),
        num_overflow=overflow.sum(dtype=torch.int32),
        overflow=overflow,
        grad_src=grad_src,
        dup_src=dup_src,
        dup_pid=dup_pid,
        num_points=n,
        num_tiles=num_tiles,
        tiles_wide=tw,
        tiles_high=th,
        feature_size=f_size,
        group_width=gw,
        num_slabs=s_edges,
        strip_cap=strip_cap,
        slab_cap=slab_cap,
        w_max=w_max,
        run_cap=run_cap,
        dup_cap=dup_cap,
        depth_bits=db,
        rows_per_block=rpb,
    )


def wide_stats(gaussians, depth, image_size, config: RasterConfig):
  """(num_wide, total_dup_rows, max_span) of the scene: the quantities
  that size stream_map's wide_cap / dup_cap and config.big_tile_window."""
  ts = config.tile_size
  mean, axis, sigma, alpha = g2d.unpack_g2d(gaussians)
  gscale = g2d.gaussian_scale(alpha, config.alpha_threshold)
  valid = (alpha > config.alpha_threshold) & (depth.reshape(-1) > 0) & (
      gscale > 0)
  lower, upper = g2d.ellipse_bounds(
      mean, axis * (sigma[:, 0] * gscale)[:, None],
      g2d.perp(axis) * (sigma[:, 1] * gscale)[:, None])
  padded = pad_to_tile(image_size, ts)
  max_tile = torch.tensor([(padded[0] - 1) // ts, (padded[1] - 1) // ts],
                          dtype=_I, device=gaussians.device)
  lo_t = _tiles_of(lower, ts, max_tile)
  hi_t = _tiles_of(upper, ts, max_tile)
  home = _tiles_of(mean, ts, max_tile)
  wide = valid & ~torch.all((home - lo_t <= 1) & (hi_t - home <= 1), -1)
  span_full = hi_t - lo_t + 1
  span = torch.clamp(span_full, max=config.big_tile_window)
  dup = span[:, 0] * span[:, 1]
  max_span = torch.max(torch.where(wide[:, None], span_full, 0))
  return wide.sum(), torch.where(wide, dup, 0).sum(), max_span


MAX_SLABS = 32

# Calibration-result compatibility version (same value and meaning as the
# reference): bumped whenever capacity/overflow semantics change.
CAPACITY_SEMANTICS = 7

W_MAX_LIMIT = 72


def calibrate_stream(gaussians, depth, features, image_size,
                     config: RasterConfig, group_width: int = 8,
                     slab_cap: int = 512, strict: bool = True) -> dict:
  """Measure fetch statistics and suggest static stream capacities such
  that a stream_map built with them reports num_overflow == 0.

  The same passes as the reference: wide-splat statistics, an unbounded
  pass for strip/run/row maxima, a replay of the greedy slab plan, and a
  validation loop at exactly the returned capacities that bumps whichever
  capacity still overflows (raising when it cannot converge unless
  ``strict=False``).  Runs on the inputs' device."""
  import dataclasses as _dc
  gw = group_width
  n_pts = gaussians.shape[0]
  dup_max = (1 << 23) if 2 * n_pts <= (1 << 23) else (
      (1 << 24) - 2 * n_pts - 1)

  def q_rows(desc, rpb):
    lo, ln = desc[..., 0], desc[..., 1]
    head = lo % rpb
    return np.where(ln > 0, ((head + ln + rpb - 1) // rpb) * rpb, 0).sum(3)

  def measure(cfg, num_slabs, s_cap, c_cap, r_cap, wide_cap, dup_cap,
              wm=W_MAX_LIMIT):
    m = stream_map(gaussians, depth, features, image_size, cfg,
                   num_slabs=num_slabs, strip_cap=s_cap, slab_cap=c_cap,
                   group_width=gw, w_max=wm, run_cap=r_cap,
                   build_table=False, wide_cap=wide_cap, dup_cap=dup_cap)
    desc = m.desc.cpu().numpy().astype(np.int64).reshape(
        m.num_groups, gw, num_slabs, wm, 4)
    return m, desc[..., 1], q_rows(desc, m.rows_per_block)

  with torch.no_grad():
    probe_cfg = _dc.replace(config, big_tile_window=1 << 20)
    n_wide, _, max_span = (int(x) for x in wide_stats(
        gaussians, depth, image_size, probe_cfg))
    btw = max(config.big_tile_window, max_span)
    config = _dc.replace(config, big_tile_window=btw)
    _, n_dup, _ = (int(x) for x in wide_stats(
        gaussians, depth, image_size, config))
    if n_wide == 0:
      wide_cap = dup_cap = 0
    else:
      wide_cap = max(64, 1 << (int(n_wide * 1.3)).bit_length())
      dup_cap = min(dup_max, max(256, 1 << (int(n_dup * 1.3)).bit_length()))

    # pass 1: unbounded capacities -> row/strip/run maxima
    m, lens, _ = measure(config, 4, 1 << 27, 1 << 27, 1 << 27, wide_cap,
                         dup_cap)
    tw, th = m.tiles_wide, m.tiles_high
    max_rows = int(lens.sum((2, 3)).max())

    rs = m.run_starts.cpu().numpy().astype(np.int64)
    runs = rs[1:] - rs[:-1]
    max_run = int(runs.max())
    csum = np.concatenate([[0], np.cumsum(runs)])
    groups_x = tw // gw
    gids = np.arange(m.num_groups)
    gy = gids // groups_x
    x0 = (gids % groups_x) * gw
    strip_len = 0
    for b in range(3):
      band = gy + b - 1
      in_img = (band >= 0) & (band < th)
      a = band * tw + np.maximum(x0 - 1, 0)
      z = band * tw + np.minimum(x0 + gw + 1, tw)
      blens = np.where(in_img, csum[np.where(in_img, z, 0)]
                       - csum[np.where(in_img, a, 0)], 0)
      strip_len = max(strip_len, int(blens.max()))

    strip_cap = 1024
    while strip_cap < strip_len * 1.1:
      strip_cap *= 2
    run_cap = 64
    while run_cap < max_run:
      run_cap *= 2

    # pass 2: replay the actual plan at (num_slabs, slab_cap)
    num_slabs = min(MAX_SLABS, max(2, 2 * -(-int(max_rows) // slab_cap)))
    for _ in range(6):
      _, lens2, qrows2 = measure(config, num_slabs, 1 << 27, slab_cap,
                                 1 << 27, wide_cap, dup_cap)
      max_slab_rows = int(qrows2.max())
      if max_slab_rows <= slab_cap or num_slabs >= MAX_SLABS:
        break
      num_slabs = min(MAX_SLABS, num_slabs + 2)
    while max_slab_rows <= slab_cap and num_slabs > 2:
      _, lens_t, qrows_t = measure(config, num_slabs - 2, 1 << 27,
                                   slab_cap, 1 << 27, wide_cap, dup_cap)
      if int(qrows_t.max()) > slab_cap:
        break
      num_slabs -= 2
      lens2, max_slab_rows = lens_t, int(qrows_t.max())
    w_max = min(W_MAX_LIMIT, int((lens2 > 0).sum(3).max()) + 2)

    # pass 3: validate the complete capacity set
    over = None
    w_seen = 0
    for _ in range(16):
      m3, lens3, qrows3 = measure(config, num_slabs, strip_cap, slab_cap,
                                  run_cap, wide_cap, dup_cap)
      over = m3.overflow.cpu().numpy()
      w_seen = int((lens3 > 0).sum(3).max())
      if over.sum() == 0 and w_seen <= w_max:
        break
      if over[0] > 0:
        wide_cap = max(64, wide_cap * 2)
        dup_cap = min(dup_max, max(256, dup_cap * 2))
      if over[1] > 0:
        strip_cap *= 2
      if over[2] > 0:
        if num_slabs + 4 > MAX_SLABS and slab_cap < 2048:
          need = int(qrows3.max())
          slab_cap = min(2048, max(slab_cap + 128,
                                   -(-need // 128) * 128 + 128))
        num_slabs = min(MAX_SLABS, num_slabs + 4)
      if over[3] > 0:
        run_cap *= 2
      if over[4] > 0 or w_seen > w_max:
        w_max = min(W_MAX_LIMIT, max(w_max, w_seen) + 2)

    if over is None or over.sum() != 0 or w_seen > w_max:
      msg = (f"calibrate_stream failed to converge: residual overflow "
             f"{[int(x) for x in over]} (causes {OVERFLOW_CAUSES}), "
             f"w_seen {w_seen} vs w_max {w_max} at num_slabs={num_slabs} "
             f"slab_cap={slab_cap} strip_cap={strip_cap} run_cap={run_cap} "
             f"wide_cap={wide_cap} dup_cap={dup_cap}")
      if strict:
        raise RuntimeError(msg)
      import warnings
      warnings.warn(msg)
      m3, lens3, _ = measure(config, num_slabs, strip_cap, slab_cap,
                             run_cap, wide_cap, dup_cap)
      over = m3.overflow.cpu().numpy()

  return {"num_slabs": num_slabs, "strip_cap": strip_cap,
          "slab_cap": slab_cap, "w_max": w_max,
          "run_cap": run_cap, "wide_cap": wide_cap, "dup_cap": dup_cap,
          "big_tile_window": btw,
          "overflow": [int(x) for x in over],
          "max_tile_rows": max_rows,
          "max_strip_rows": strip_len, "max_run": max_run,
          "max_slab_rows": max_slab_rows, "num_wide": n_wide,
          "num_dup_rows": n_dup}
