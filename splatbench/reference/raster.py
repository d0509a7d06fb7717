"""Plain reference of the tile-stream rasterizer: its binning of splats to
16x16 tiles, its compositing order, alpha blending with the saturation
freeze, the gradients of a per-tile loss and the point heuristics.

Semantics (the renderer's, written out here from its definition):

* a splat is drawn where alpha > alpha_threshold and its NDC depth > 0;
  its cull radius is r = sqrt(2 ln(alpha / threshold)) sigmas, and it is
  listed in every tile that the axis-aligned box of that ellipse meets
  (tiles clamped to the image's tile grid);
* the order within a tile: 14-bit depth d14 = int(clamp(d * 65535, 0,
  65535)) >> 2, then, among equal d14, the splat's home tile (the tile of
  its mean) relative to this tile, row of homes before column (above
  before below, left before right), then the splat's reach on y and on x
  (0: its own row or column only, 1: also the next, 2: both neighbours,
  3: also the previous), then the splat id.  A splat whose box reaches
  more than one tile past its home is listed in the tiles outside the
  3x3 block of its home as if homed there, with reach 0 and after every
  splat of that tile with the same key;
* at each pixel (tile-centred coordinates, pixel centres at +0.5), alpha
  = min(a, clamp_max_alpha) where a = alpha * exp(-(u^2 + v^2) / 2) >
  alpha_threshold, else 0; log transmittance lt = the exclusive running
  sum of log(1 - alpha); a splat contributes weight alpha * exp(lt) while
  lt > log(1 - saturate_threshold), and nothing after;
* output per tile: (F + 1, 256): the features weighted, then the weight
  sum;
* heuristics per splat: visibility = sum of its weights; prune_cost =
  alpha_s^2 * sum of (dL/d alpha)^2 over its contributing pixels;
  split_score = sum over pixels where alpha is not clamped of |dL/d
  mean_x| + |dL/d mean_y| at that pixel.

Everything is computed in blocks of tiles of similar list length, so the
full 2M-splat scenes fit; gradients come from autograd, per block.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .project import cull_radius, extent

TILE = 16


def grid(image_size, tile=TILE):
  """(tiles_wide, tiles_high)."""
  return -(-image_size[0] // tile), -(-image_size[1] // tile)


@dataclass
class Pairs:
  """The (tile, splat) list in compositing order."""
  splat: torch.Tensor     # (P,) int64
  starts: torch.Tensor    # (T + 1,) int64: the rows of tile t
  num_tiles: int
  tiles_wide: int

  @property
  def count(self) -> int:
    return int(self.splat.shape[0])


def _reach(lo, hi, home):
  neg, pos = lo < home, hi > home
  return torch.where(neg & pos, 2, torch.where(neg, 3, torch.where(pos, 1,
                                                                   0)))


def splat_tiles(packed, depth, image_size, alpha_threshold, tile=TILE):
  """Per splat: (valid, lo (N, 2), hi (N, 2), home (N, 2)) tile indices."""
  tw, th = grid(image_size, tile)
  mean, axis, sigma, alpha = (packed[:, 0:2], packed[:, 2:4],
                              packed[:, 4:6], packed[:, 6])
  r = cull_radius(alpha, alpha_threshold)
  valid = (alpha > alpha_threshold) & (depth > 0) & (r > 0)
  ext = extent(axis, sigma, r)
  top = torch.tensor([tw - 1, th - 1], device=packed.device)

  def tile_of(x):
    return torch.minimum(torch.clamp(torch.floor(x / tile).long(), min=0),
                         top)
  return valid, tile_of(mean - ext), tile_of(mean + ext), tile_of(mean)


def bin_splats(packed, depth, image_size, alpha_threshold,
               tile=TILE) -> Pairs:
  """Every (tile, splat) pair of the listing, sorted into compositing
  order (see the module docstring)."""
  packed, depth = packed.detach(), depth.detach()
  n = packed.shape[0]
  tw, th = grid(image_size, tile)
  valid, lo, hi, home = splat_tiles(packed, depth, image_size,
                                    alpha_threshold, tile)
  ids = torch.nonzero(valid)[:, 0]
  lo, hi, home = lo[ids], hi[ids], home[ids]
  span = hi - lo + 1
  count = span[:, 0] * span[:, 1]
  rep = torch.repeat_interleave(torch.arange(ids.shape[0],
                                             device=ids.device), count)
  first = torch.cumsum(count, 0) - count
  j = torch.arange(rep.shape[0], device=ids.device) - first[rep]
  tx = lo[rep, 0] + j % span[rep, 0]
  ty = lo[rep, 1] + j // span[rep, 0]
  hx, hy = home[rep, 0], home[rep, 1]
  core = ((tx - hx).abs() <= 1) & ((ty - hy).abs() <= 1)
  yc = _reach(lo[:, 1], hi[:, 1], home[:, 1])[rep]
  xc = _reach(lo[:, 0], hi[:, 0], home[:, 0])[rep]
  one = torch.ones_like(tx)
  b = torch.where(core, hy - ty + 1, one)
  k = torch.where(core, hx - tx + 1, one)
  yc = torch.where(core, yc, 0)
  xc = torch.where(core, xc, 0)
  sid = ids[rep]
  pid = torch.where(core, sid, sid + n)
  d14 = (torch.clamp(depth[sid] * 65535.0, 0.0, 65535.0).long() >> 2)
  tile_id = ty * tw + tx
  key = ((tile_id << 47) | (d14 << 33) | (b << 31) | (k << 29) | (yc << 27)
         | (xc << 25) | pid)
  order = torch.sort(key).indices
  tile_sorted = tile_id[order]
  starts = torch.searchsorted(tile_sorted, torch.arange(
      tw * th + 1, device=ids.device))
  return Pairs(sid[order], starts, tw * th, tw)


def count_pairs(packed, depth, image_size, alpha_threshold,
                tile=TILE) -> int:
  """(splat, tile) pairs of the listing: the tiles each drawn splat's box
  meets, summed over splats."""
  valid, lo, hi, _ = splat_tiles(packed.detach(), depth.detach(),
                                 image_size, alpha_threshold, tile)
  span = (hi - lo + 1).prod(-1)
  return int(torch.where(valid, span, 0).sum())


def _blocks(pairs: Pairs, budget: int):
  """Groups of tiles with similar list lengths, each block's tiles x its
  longest list x 256 pixels at most ``budget`` (or one tile)."""
  lengths = pairs.starts[1:] - pairs.starts[:-1]
  order = torch.argsort(lengths, descending=True).tolist()
  lens = lengths.tolist()
  blocks, cur, cur_len = [], [], 0
  for t in order:
    if lens[t] == 0:
      break
    if cur and (len(cur) + 1) * cur_len * TILE * TILE > budget:
      blocks.append((cur, cur_len))
      cur = []
    if not cur:
      cur_len = lens[t]
    cur.append(t)
  if cur:
    blocks.append((cur, cur_len))
  return blocks


@dataclass
class Result:
  image: torch.Tensor          # (T, F + 1, 256), detached
  loss: float = 0.0
  grad_packed: torch.Tensor = None
  grad_features: torch.Tensor = None
  visibility: torch.Tensor = None
  prune_cost: torch.Tensor = None
  split_score: torch.Tensor = None


def composite(packed, features, pairs: Pairs, cfg, tile_loss=None,
              dtype=torch.float32, budget: int = 1 << 25) -> Result:
  """Blend every tile's list.  With ``tile_loss(image_block (B, F + 1,
  256), tiles (B,)) -> scalar`` also the loss summed over the blocks, its
  gradients with respect to ``packed`` and ``features`` and the three
  heuristics.  ``dtype`` is the precision of every per-pixel quantity
  (the listing is always exact)."""
  dev = packed.device
  n, f = features.shape
  thr, cmax = cfg["alpha_threshold"], cfg["clamp_max_alpha"]
  cut = 1.0 - cfg["saturate_threshold"]
  lcut = math.log(cut) if cut > 0 else -1e30
  pk = packed.detach().to(dtype)
  ft = features.detach().to(dtype)
  p = torch.arange(TILE * TILE, device=dev)
  pxl = ((p % TILE).to(dtype) + 0.5 - TILE * 0.5)
  pyl = ((p // TILE).to(dtype) + 0.5 - TILE * 0.5)
  image = torch.zeros((pairs.num_tiles, f + 1, TILE * TILE), dtype=dtype,
                      device=dev)
  res = Result(image)
  grad = tile_loss is not None
  if grad:
    res.grad_packed = torch.zeros((n, 7), dtype=dtype, device=dev)
    res.grad_features = torch.zeros((n, f), dtype=dtype, device=dev)
    res.visibility = torch.zeros(n, dtype=dtype, device=dev)
    res.prune_cost = torch.zeros(n, dtype=dtype, device=dev)
    res.split_score = torch.zeros(n, dtype=dtype, device=dev)
    loss_total = torch.zeros((), dtype=torch.float64, device=dev)
  for tiles, length in _blocks(pairs, budget):
    t = torch.tensor(tiles, device=dev)
    slot = torch.arange(length, device=dev)
    first = pairs.starts[t][:, None]
    valid = slot[None, :] < (pairs.starts[t + 1][:, None] - first)
    idx = pairs.splat[torch.where(valid, first + slot, 0)]
    rows = pk[idx].requires_grad_(grad)
    fr = ft[idx].requires_grad_(grad)
    with torch.set_grad_enabled(grad):
      ox = ((t % pairs.tiles_wide) * TILE).to(dtype)[:, None] + TILE * 0.5
      oy = ((t // pairs.tiles_wide) * TILE).to(dtype)[:, None] + TILE * 0.5
      ax, ay = rows[..., 2, None], rows[..., 3, None]
      sx, sy = rows[..., 4, None], rows[..., 5, None]
      dx = pxl - (rows[..., 0] - ox)[..., None]            # (B, L, 256)
      dy = pyl - (rows[..., 1] - oy)[..., None]
      u = (ax * dx + ay * dy) / sx
      v = (ax * dy - ay * dx) / sy
      a_raw = rows[..., 6, None] * torch.exp(-0.5 * (u * u + v * v))
      on = valid[..., None] & (a_raw > thr)
      alpha = torch.where(on, torch.clamp(a_raw, max=cmax), 0.0)
      log_t = torch.log1p(-alpha)
      lt = torch.nn.functional.pad(torch.cumsum(log_t, 1)[:, :-1],
                                   (0, 0, 1, 0))
      live = lt > lcut
      w = torch.where(live, alpha * torch.exp(lt), 0.0)
      out = torch.cat([torch.einsum("blf,blp->bfp", fr, w),
                       w.sum(1)[:, None]], 1)
    res.image[t] = out.detach()
    if not grad:
      continue
    loss = tile_loss(out, t)
    g_rows, g_fr, g_alpha = torch.autograd.grad(loss, (rows, fr, alpha))
    loss_total += loss.detach().double()
    sel = idx[valid]
    res.grad_packed.index_add_(0, sel, g_rows[valid])
    res.grad_features.index_add_(0, sel, g_fr[valid])
    with torch.no_grad():
      res.visibility.index_add_(0, sel, w.sum(-1)[valid])
      ag = torch.where(live & (alpha > 0), g_alpha, 0.0)
      pa = rows[..., 6]
      res.prune_cost.index_add_(0, sel, (pa * pa * (ag * ag).sum(-1))[valid])
      z = torch.where(a_raw < cmax, ag * a_raw, 0.0)
      # d a_raw / d mean = a_raw * (u du/dmean... ): the rotated frame
      gx = z * (u * ax / sx - v * ay / sy)
      gy = z * (u * ay / sx + v * ax / sy)
      res.split_score.index_add_(0, sel, (gx.abs() + gy.abs()).sum(-1)[valid])
  if grad:
    res.loss = float(loss_total)
  return res
