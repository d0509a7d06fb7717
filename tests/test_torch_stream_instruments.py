"""Port vs reference, and vs plain formulas: the profiling instruments of
the stream kernels (``stream_forward(..., ablate=, with_counts=)``,
``stream_backward(..., ablate=)``) through their CPU twins.

* K1's counts: row g * 8 of the block (the computed (tile, slab)
  iterations of tile group g) equals the reference's
  ``stream_forward(..., with_counts=True)`` exactly, run in TPU interpret
  mode (``port_compare.tpu_reference_mode``) on the reference's own
  mapping carried across by ``convert.py``; one scene is opaque enough
  that saturation skips slabs.  Rows g * 8 + 1 and + 2 (the rows staged,
  the (row, warp) pairs the warps list) hold against a count in numpy
  from the descriptors and each row's footprint (``quad_footprint``'s
  rule, written out again here).
* ``ablate=""`` is the plain call, bit for bit; each mode follows its
  formula: no_sort is the full twin on a table whose slabs are already in
  rank order, no_alpha's weight channel is 1 - prod(1 - 1e-6 x) over the
  rows each pixel's warp lists, K2's skeleton and no_grad fill the
  accumulators as stated (a one-splat scene gives no_grad's tile sums in
  closed form), no_copyback's one value is the sum of the full
  accumulators.
* ``profile_gate``, the tolerance the kernels are held to against these
  twins on the card, fails a no_alpha image that dropped its faintest
  row, and each of its branches passes and fails where it should.
* Unknown modes, and modes on a sharded mapping, raise.

Why the ablated outputs are not compared with the reference's: the
reference's modes replace phases of its TPU kernel by expressions over
its own lane layout (``rows_t[0:f + 1, 0:pix] * 1e-9``, ``l * 0.9`` for
the masked cumsum, ``jnp.sum(rows_t) * 1e-20`` over stale scratch
lanes), which have no meaning outside that layout; each Hopper mode
takes out the phase of the Hopper kernel that does the same job instead.
So only the default outputs and the counts of computed slabs can be
compared with the reference.  The kernels are held against these twins
on the card in ``test_torch_gpu.py`` and ``chip_smoke.py`` phase 15.
"""

import dataclasses
import math

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import port_compare as pc  # noqa: E402
from random_data import random_2d_gaussians  # noqa: E402
from test_stream import TIGHT, make_scene  # noqa: E402
from tpu_splatting import RasterConfig  # noqa: E402
from tpu_splatting.rasterizer import stream as jstream  # noqa: E402
from tpu_splatting.rasterizer import stream_kernels as jkern  # noqa: E402
from tpu_splatting.misc.renderer2d import project_gaussians2d  # noqa: E402
from tpu_splatting_torch import calibrate_stream, stream_map  # noqa: E402
from tpu_splatting_torch.rasterizer import (  # noqa: E402
    stream_kernels as tkern)

SIZE = (32, 24)
CONFIG = RasterConfig(tile_size=8, chunk_size=8)
CAP_KEYS = ("num_slabs", "strip_cap", "slab_cap", "w_max", "run_cap",
            "wide_cap", "dup_cap")
STRIP_SLACK = 512            # rasterizer/stream.py
HEUR = dict(compute_point_heuristic=True, compute_visibility=True)


def opaque_scene(seed=3, n=100):
  """Large, nearly opaque splats in slabs of 32 rows: a third of the
  slabs that hold rows come after their tile saturated."""
  rng = np.random.default_rng(seed)
  g2 = random_2d_gaussians(rng, n, SIZE, num_channels=3, scale_factor=3.0,
                           alpha_range=(0.9, 0.99), dtype=jnp.float32)
  depths = jnp.asarray(rng.permutation(n).astype(np.float32) + 0.5) / n
  return project_gaussians2d(g2), depths, g2.feature


def reference_mapping(case):
  """(JAX mapping, the port's copy of it) of a scene at SIZE, tile 8."""
  if case == "sparse":
    packed, depths, feats = make_scene(0, 80, SIZE)
    caps = TIGHT
  else:
    packed, depths, feats = opaque_scene()
    cal = calibrate_stream(pc.t(packed), pc.t(depths), pc.t(feats), SIZE,
                           pc.config(CONFIG), group_width=2, slab_cap=32)
    caps = {k: cal[k] for k in CAP_KEYS}
  mj = jstream.stream_map(packed, depths, feats, SIZE, CONFIG,
                          group_width=2, **caps)
  assert int(mj.num_overflow) == 0
  return mj, pc.mapping(mj)


def port_mapping(packed, depth, feats, config=CONFIG, slab_cap=64):
  cfg = pc.config(config)
  cal = calibrate_stream(packed, depth, feats, SIZE, cfg, group_width=2,
                         slab_cap=slab_cap)
  m = stream_map(packed, depth, feats, SIZE, cfg, group_width=2,
                 **{k: cal[k] for k in CAP_KEYS})
  assert int(m.num_overflow) == 0
  return m, cfg


def sparse_port_mapping(config=CONFIG):
  packed, depths, feats = make_scene(1, 120, SIZE)
  return port_mapping(pc.t(packed), pc.t(depths), pc.t(feats), config)


# --- an independent count, in numpy -----------------------------------------

def np_footprint(row, ox, oy, thr, reach):
  """``quad_footprint``'s rectangle [x0, x1, y0, y1] of one table row in
  the tile-centred basis, its ends rounded outward to float32."""
  f32 = np.float32
  mlx, mly = f32(row[0]) - f32(ox), f32(row[1]) - f32(oy)
  ax, ay, sx, sy, pa = (f32(v) for v in row[2:7])
  isx2 = f32(1.0) / max(sx * sx, f32(1e-24))
  isy2 = f32(1.0) / max(sy * sy, f32(1e-24))
  a2, b2 = ax * ax, ay * ay
  cxx = f32(-0.5) * (a2 * isx2 + b2 * isy2)
  cyy = f32(-0.5) * (b2 * isx2 + a2 * isy2)
  cxy = -(ax * ay * (isx2 - isy2))
  cx = -(f32(2.0) * cxx * mlx + cxy * mly)
  cy = -(f32(2.0) * cyy * mly + cxy * mlx)
  c1 = (cxx * mlx * mlx + cxy * mlx * mly + cyy * mly * mly
        + np.log(max(pa, f32(1e-30))))
  a, b, c, d, e, f = (float(v) for v in (cxx, cxy, cyy, cx, cy, c1))
  inf = math.inf
  whole = [-inf, inf, -inf, inf]
  det = a * c - 0.25 * b * b
  if not (a < 0.0 and c < 0.0 and det > 0.0):
    return whole
  s = (abs(a) + abs(b) + abs(c)) * reach * reach + (abs(d) + abs(e)) * reach
  s += abs(f)
  inv = 1.0 / det
  xs = -0.5 * (c * d - 0.5 * b * e) * inv
  ys = -0.5 * (a * e - 0.5 * b * d) * inv
  room = f + 0.5 * (d * xs + e * ys) - (
      math.log(float(f32(thr))) - 1e-6 - 2.0 ** -21 * s)
  if room <= 0.0:
    return [inf, -inf, inf, -inf]
  hx, hy = math.sqrt(room * -c * inv), math.sqrt(room * -a * inv)
  ends = [xs - hx, xs + hx, ys - hy, ys + hy]
  if not all(math.isfinite(v) for v in ends):
    return whole
  out = []
  for k, v in enumerate(ends):
    r = np.float32(v)
    if k % 2 == 0 and float(r) > v:
      r = np.nextafter(r, np.float32(-inf))
    if k % 2 == 1 and float(r) < v:
      r = np.nextafter(r, np.float32(inf))
    out.append(float(r))
  return out


def np_warp_rects(ts, threads):
  """Each warp's pixel-centre rectangle (``pixel_of``: an 8x4 block a warp
  at tiles of a multiple of 8)."""
  rects = []
  for w in range(threads // 32):
    xs, ys = [], []
    for lane in range(32):
      tid = 32 * w + lane
      if ts % 8 == 0:
        p = (((w // (ts // 8)) * 4 + lane // 8) * ts + (w % (ts // 8)) * 8
             + lane % 8)
      else:
        p = tid
      if p < ts * ts:
        xs.append(p % ts + 0.5 - ts * 0.5)
        ys.append(p // ts + 0.5 - ts * 0.5)
    rects.append((min(xs), max(xs), min(ys), max(ys)))
  return rects


def np_walk(m, config):
  """Per tile, K1's walk without saturation: {tile: [(slab, table row,
  [warps that list it])]} over slab 0 and every used slab, each window's
  rows clamped as K1's assembly clamps them."""
  t_all, s_all, w_max = m.num_tiles, m.num_slabs, m.w_max
  desc = m.desc.numpy().reshape(t_all, s_all, w_max, 4)
  sb = m.strip_blk.numpy()
  table = m.table.numpy().reshape(-1, m.table.shape[1] // m.rows_per_block)
  ts, rpb = config.tile_size, m.rows_per_block
  wrects = np_warp_rects(ts, -(-ts * ts // 32) * 32)
  out = {}
  for t in range(t_all):
    g = t // m.group_width
    ox = (t % m.tiles_wide) * ts + ts * 0.5
    oy = (t // m.tiles_wide) * ts + ts * 0.5
    out[t] = []
    for s in range(s_all):
      if s > 0 and desc[t, s, 0, 1] <= 0:
        continue
      cur = 0
      for lo, ln, _, cls in desc[t, s]:
        b = cls // 3
        head = lo % rpb
        length = max(min(ln, m.slab_cap - (cur + head)), 0)
        row0 = sb[g, b] * m.strip_cap + lo - b * (2 * m.strip_cap
                                                  + STRIP_SLACK)
        if length > 0:
          cur += -(-(head + length) // rpb) * rpb
        for r in range(length):
          row = table[row0 + r]
          rect = np_footprint(row, ox, oy, config.alpha_threshold,
                              ts * 0.5 - 0.5)
          warps = [k for k, (x0, x1, y0, y1) in enumerate(wrects)
                   if rect[0] <= x1 and x0 <= rect[1] and rect[2] <= y1
                   and y0 <= rect[3]]
          out[t].append((s, row0 + r, warps))
  return out


# --- K1's counts ------------------------------------------------------------

@pytest.mark.parametrize("case", ["sparse", "opaque"])
def test_computed_slabs_match_reference(case):
  mj, mt = reference_mapping(case)
  with pc.tpu_reference_mode():
    _, want = jkern.stream_forward(mj, CONFIG, with_counts=True)
    want = np.asarray(want)
  image, got = tkern.stream_forward(mt, pc.config(CONFIG), with_counts=True)
  assert got.shape == want.shape == (mt.num_groups * 8, 128)
  np.testing.assert_array_equal(got[0::8].numpy(), want[0::8])
  assert torch.equal(image, tkern.stream_forward(mt, pc.config(CONFIG)))
  used = tkern._used_slabs(mt)
  used[:, 0] = True
  total = int(got[0::8, 0].sum())
  assert total <= mt.num_tiles * mt.num_slabs
  if case == "opaque":
    # saturation skipped slabs that hold rows
    assert total < int(used.sum()) <= mt.num_tiles * mt.num_slabs


def test_counts_match_numpy():
  """Rows staged and (row, warp) pairs listed, per group, against the
  numpy walk of a scene that does not saturate."""
  m, cfg = sparse_port_mapping()
  _, counts = tkern.stream_forward(m, cfg, with_counts=True)
  walk = np_walk(m, cfg)
  want = np.zeros((m.num_groups, 3), np.int64)
  for t, rows in walk.items():
    g = t // m.group_width
    want[g, 0] += 1 + len({s for s, _, _ in rows if s > 0})
    want[g, 1] += len(rows)
    want[g, 2] += sum(len(w) for _, _, w in rows)
  assert want[:, 2].sum() > 0 and want[:, 2].sum() < want[:, 1].sum() * 2
  np.testing.assert_array_equal(counts[0::8, 0].numpy(), want[:, 0])
  np.testing.assert_array_equal(counts[1::8, 0].numpy(), want[:, 1])
  np.testing.assert_array_equal(counts[2::8, 0].numpy(), want[:, 2])
  assert not bool(counts[1::8, 1:].any()) and not bool(counts[3::8].any())
  for k in range(4, 8):
    assert not bool(counts[k::8].any())
  assert bool((counts[0::8] == counts[0::8, :1]).all())


def test_skeleton_counts_are_the_floor_probes():
  m, cfg = sparse_port_mapping()
  image, counts = tkern.stream_forward(m, cfg, ablate="skeleton",
                                       with_counts=True)
  assert torch.equal(image, tkern.stream_forward_floor_reference(m, cfg))
  _, full = tkern.stream_forward(m, cfg, with_counts=True)
  assert torch.equal(counts[0::8], full[0::8])
  assert torch.equal(counts[1::8], full[1::8])
  assert not bool(counts[2::8].any())


# --- the modes' formulas ----------------------------------------------------

def test_default_mode_is_the_plain_call():
  m, cfg = sparse_port_mapping()
  plain = tkern.stream_forward(m, cfg)
  assert torch.equal(tkern.stream_forward(m, cfg, ablate=""), plain)
  assert torch.equal(tkern.stream_forward(m, cfg, with_counts=True)[0],
                     plain)
  hcfg = dataclasses.replace(cfg, **HEUR)
  gimg = torch.from_numpy(np.random.default_rng(0).normal(
      size=plain.shape).astype(np.float32))
  assert torch.equal(tkern.stream_backward(m, plain, gimg, hcfg, ablate=""),
                     tkern.stream_backward(m, plain, gimg, hcfg))


def rank_ordered(m):
  """The mapping with every row's depth set to 0: rank order is slot
  order in every slab."""
  w_pad = m.table.shape[1] // m.rows_per_block
  table = m.table.clone().view(-1, w_pad)
  table[:, 7 + m.feature_size] = 0.0
  return dataclasses.replace(m, table=table.view_as(m.table))


def test_no_sort_is_the_full_walk_in_rank_order():
  m, cfg = sparse_port_mapping()
  assert not torch.equal(tkern.stream_forward(m, cfg, ablate="no_sort"),
                         tkern.stream_forward(m, cfg))
  m = rank_ordered(m)
  full = tkern.stream_forward(m, cfg)
  assert torch.equal(tkern.stream_forward(m, cfg, ablate="no_mask"), full)
  hcfg = dataclasses.replace(cfg, **HEUR)
  gimg = torch.ones_like(full)
  assert torch.equal(
      tkern.stream_backward(m, full, gimg, hcfg, ablate="no_sort"),
      tkern.stream_backward(m, full, gimg, hcfg))


def test_no_alpha_weight_in_closed_form():
  """Weight channel = 1 - prod(1 - 1e-6 x) over the rows the pixel's warp
  lists, in every slab (alpha this small never saturates)."""
  m, cfg = sparse_port_mapping()
  image = tkern.stream_forward(m, cfg, ablate="no_alpha")
  table = m.table.numpy().reshape(-1, m.table.shape[1] // m.rows_per_block)
  ts, f = cfg.tile_size, m.feature_size
  warp_of = np.zeros(ts * ts, np.int64)
  for w in range(ts * ts // 32):
    for lane in range(32):
      p = (((w // (ts // 8)) * 4 + lane // 8) * ts + (w % (ts // 8)) * 8
           + lane % 8)
      warp_of[p] = w
  want = np.zeros((m.num_tiles, ts * ts))
  for t, rows in np_walk(m, cfg).items():
    for w in range(ts * ts // 32):
      keep = np.prod([1.0 - 1e-6 * float(np.float32(table[r, 0]))
                      for _, r, warps in rows if w in warps])
      want[t, warp_of == w] = 1.0 - keep
  assert want.max() > 1e-6
  np.testing.assert_allclose(image[:, f].numpy(), want, rtol=1e-4, atol=1e-9)


def test_profile_gate_holds_no_alpha_to_its_faint_image():
  """``profile_gate`` holds no_alpha per channel relative to the image: a
  kernel that dropped the listed row nearest the left edge (its alpha 1e-6
  x its x, here its column 0 set to 0) stays within K1's absolute 1e-4
  and fails the gate; the twin's own image, and one off by a relative
  1e-6, pass."""
  m, cfg = sparse_port_mapping()
  want = tkern.stream_forward(m, cfg, ablate="no_alpha")
  w_pad = m.table.shape[1] // m.rows_per_block
  table = m.table.view(-1, w_pad)
  listed = {r for rows in np_walk(m, cfg).values() for _, r, warps in rows
            if warps}
  r = min(listed, key=lambda r: float(table[r, 0]))
  dropped = m.table.clone().view(-1, w_pad)
  dropped[r, 0] = 0.0
  got = tkern.stream_forward(
      dataclasses.replace(m, table=dropped.view_as(m.table)), cfg,
      ablate="no_alpha")
  err, used = tkern.profile_gate(got, want, "stream_forward", "no_alpha")
  assert 0.0 < err < 1e-4 and used > 1.0, (err, used)
  assert tkern.profile_gate(want, want, "stream_forward", "no_alpha") == (
      0.0, 0.0)
  err, used = tkern.profile_gate(want * (1.0 + 1e-6), want,
                                 "stream_forward", "no_alpha")
  assert used <= 1.0, (err, used)


@pytest.mark.parametrize("kernel, ablate, case, passes", [
    ("stream_forward", "skeleton", "ulp", False),
    ("stream_forward", "no_sort", "abs 5e-5", True),
    ("stream_forward", "no_mask", "abs 2e-4", False),
    ("stream_forward", "", "nan", False),
    ("stream_backward", "no_grad", "rel 5e-4", True),
    ("stream_backward", "no_grad", "rel 2e-3", False),
    ("stream_backward", "skeleton", "rel 5e-4", False),
    ("stream_backward", "no_sort", "rel 5e-5", True),
    ("stream_backward", "no_copyback", "rel 5e-4", True),
    ("stream_backward", "no_copyback", "stray", False),
    ("stream_backward", "no_grad", "zero twin", False)])
def test_profile_gate_tolerances(kernel, ablate, case, passes):
  """Each branch of ``profile_gate`` on a twin of random values (a
  no_copyback twin: one value): within its tolerance it passes, past it,
  off by one ulp where it is exact, with a NaN, a stray entry or a twin of
  zeros it fails."""
  gen = torch.Generator().manual_seed(0)
  shape = (6, 4, 64) if kernel == "stream_forward" else (40, 13)
  want = torch.rand(shape, generator=gen) * 0.5 + 0.5
  if ablate == "no_copyback":
    want = torch.zeros(shape)
    want[0, 0] = 3e-18
  got = want.clone()
  if case == "ulp":
    got[1, 2, 3] = torch.nextafter(got[1, 2, 3], torch.tensor(2.0))
  elif case.startswith("abs "):
    got[1, 2, 3] += float(case.split()[1])
  elif case.startswith("rel "):
    got[0, 0] *= 1.0 + float(case.split()[1])
  elif case == "nan":
    got[0, 0, 0] = math.nan
  elif case == "stray":
    got[3, 1] = 1e-30
  elif case == "zero twin":
    want.zero_()
  used = tkern.profile_gate(got, want, kernel, ablate)[1]
  assert (used <= 1.0) == passes, used


def one_splat(pa=0.8):
  """One splat in the middle of the image, 2 px wide, features 0.1, 0.2,
  0.3 (stream table columns: mean, axis, sigmas, point alpha)."""
  packed = torch.tensor([[13.3, 10.7, 0.8, 0.6, 2.0, 1.5, pa]])
  return (packed, torch.tensor([0.5]), torch.tensor([[0.1, 0.2, 0.3]]))


def test_backward_skeleton_and_no_grad_fill_the_accumulators():
  """One splat: each tile that stages its row adds skeleton's 1e-20 * the
  sum of the row's values, or no_grad's 1e-20 * sum of alpha_grad over
  the tile, into the accumulator's every column; columns past the seven
  packed-gaussian ones leave the flush as they are.  With a cotangent of
  ones a lone row's alpha_grad is g.f = 1.6 at every pixel where it is
  alive, so no_grad's column sums to 1e-20 * 1.6 * the live pixels."""
  packed, depth, feats = one_splat()
  cfg_v = dataclasses.replace(CONFIG, compute_visibility=True)
  m, cfg = port_mapping(packed, depth, feats, cfg_v)
  image = tkern.stream_forward(m, cfg)
  gimg = torch.ones_like(image)
  table = m.table.view(-1, m.table.shape[1] // m.rows_per_block)
  staged = tkern._staged_lengths(m)
  tiles = int((staged.sum((1, 2)) > 0).sum())
  assert tiles > 1
  row = table[int(tkern._window_slots(m)[2][staged > 0][0])]
  total = row[0]
  for c in range(1, 8 + m.feature_size):
    total = total + row[c]
  skel = tkern.stream_backward(m, image, gimg, cfg, ablate="skeleton")
  want = float(total * 1e-20) * tiles
  np.testing.assert_allclose(skel[:, 7:].sum(0).numpy(), want, rtol=1e-6)

  # the live pixels: alpha above the threshold (pa exp(-(u^2 + v^2) / 2))
  mx, my, ax, ay, sx, sy, pa = (float(v) for v in packed[0])
  ys, xs = np.mgrid[0:SIZE[1], 0:SIZE[0]] + 0.5
  u = ((xs - mx) * ax + (ys - my) * ay) / sx
  v = (-(xs - mx) * ay + (ys - my) * ax) / sy
  a_raw = pa * np.exp(-0.5 * (u * u + v * v))
  thr = cfg.alpha_threshold
  assert np.abs(a_raw / thr - 1.0).min() > 1e-3
  live = int((a_raw > thr).sum())
  grad = tkern.stream_backward(m, image, gimg, cfg, ablate="no_grad")
  np.testing.assert_allclose(grad[:, 7:].sum(0).numpy(), 1e-20 * 1.6 * live,
                             rtol=1e-5)


def test_no_copyback_is_the_sum_of_the_accumulators():
  """With antialias and every point alpha 1 the flush leaves the
  accumulators as they are, so no_copyback's one value is 1e-20 * the
  full buffer's sum."""
  m, cfg = sparse_port_mapping()
  w_pad = m.table.shape[1] // m.rows_per_block
  table = m.table.clone().view(-1, w_pad)
  table[:, 6] = 1.0
  m = dataclasses.replace(m, table=table.view_as(m.table))
  cfg = dataclasses.replace(cfg, antialias=True, **HEUR)
  image = tkern.stream_forward(m, cfg)
  gimg = torch.from_numpy(np.random.default_rng(2).uniform(
      0.5, 1.5, image.shape).astype(np.float32))
  full = tkern.stream_backward(m, image, gimg, cfg)
  got = tkern.stream_backward(m, image, gimg, cfg, ablate="no_copyback")
  assert not bool(got.flatten()[1:].any())
  want = 1e-20 * float(full.double().sum())
  assert abs(want) > 1e-22
  assert abs(float(got[0, 0]) - want) <= 1e-5 * abs(want)


def test_profiling_modes_raise():
  m, cfg = sparse_port_mapping()
  image = tkern.stream_forward(m, cfg)
  with pytest.raises(ValueError, match="unknown ablate"):
    tkern.stream_forward(m, cfg, ablate="no_grad")
  with pytest.raises(ValueError, match="unknown ablate"):
    tkern.stream_backward(m, image, image, cfg, ablate="no_alpha")
  with pytest.raises(ValueError, match="unsharded"):
    tkern.stream_forward(m, cfg, band0=1, ablate="no_sort")
  with pytest.raises(ValueError, match="unsharded"):
    tkern.stream_forward(m, cfg, band0=2, with_counts=True)
  with pytest.raises(ValueError, match="unsharded"):
    tkern.stream_backward(m, image, image, cfg, halo=True, ablate="no_grad")
  with pytest.raises(ValueError, match="unsharded"):
    tkern.stream_backward(m, image, image, cfg, band0=1, halo=True,
                          ablate="skeleton")
  packed, depths, _ = make_scene(1, 120, SIZE)
  wide = pc.t(np.random.default_rng(4).uniform(size=(120, 8)),
              torch.float32)
  mw, cfg = port_mapping(pc.t(packed), pc.t(depths), wide)
  with pytest.raises(ValueError, match="<4> instantiation only"):
    tkern.stream_forward(mw, cfg, ablate="no_alpha")
  image = tkern.stream_forward(mw, cfg)
  with pytest.raises(ValueError, match="<6> instantiation only"):
    tkern.stream_backward(mw, image, image, cfg, ablate="no_grad")
  assert not any(tkern.probe_launch_counts.values())
