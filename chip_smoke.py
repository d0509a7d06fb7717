#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. Device and build: needs CUDA, prints the card's name and power limit,
   builds every kernel from ``tpu_splatting_torch/csrc`` (one ``nvcc``
   per source, all in parallel: the stream forward K1 and backward K2
   with the halo merge, the sorted forward K4 and backward K5, the layout
   kernels K6, K7 and the row-gather probe, the exp_mosaic probes T1-T4,
   the exp_pack and exp_pack2 probes)
   and prints each kernel instantiation's registers and spills (K2's and
   K5's as <most features, reduction width V>; the generic
   instantiations, which take any feature count and tile, as
   *_generic_kernel).  Then, for every kernel at the headline shapes, the
   instantiation, threads and shared memory the wrapper's plan picks and
   the resident blocks and warps per SM
   (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); and the plans'
   shared-memory formulas (Python) against the kernels' own ``*_smem``
   entries (C) over a grid of feature counts, tiles and capacities; and
   that the floor probes of K1 and K4 (their walk taken out) kept their
   staging loads and shared stores in the SASS (``cuobjdump -sass``), and
   that T3's kernel and T4's bulk instantiation kept a bulk asynchronous
   copy (the SASS opcode found is printed; T4's loads instantiation has
   none).
2. Kernels against their plain twins on the card: 200k splats at
   1024x768 (``scenes.uniform_scene``; K1 in blending, antialias and
   quantile modes, K2 in blending, antialias and heuristics + visibility
   modes; both again at 64 features and at ``tile_size`` 4, past the
   register instantiations and below a whole warp) and 200k splats with
   ``scenes.heavy_scene`` statistics
   (calibrated from slab_cap 1024 and from 128: many slabs, duplicate
   rows), each mapped by the port's own ``calibrate_stream`` +
   ``stream_map``; plus one small 3D scene mapped on the card and on the
   CPU (identical mapping), composited by the kernel and by the twin on
   the CPU, and trained one ``render_with_heuristics`` step on each
   (loss, gradients and heuristics agree).  K2's home-major buffer is
   compared column by column: max |kernel - twin| <= 1e-4 * max |twin
   column| + 1e-6 (its atomics sum in a varying order).
3. The forward render at full size: 2M splats at 2048x1536, SH degree 3
   (``scenes.uniform_scene`` lifted to 3D), five ``render_gaussians``
   requests under ``torch.no_grad()`` (the last with the median-depth
   pass), checked for zero overflow, finite images and weights in [0, 1],
   with the K1 launch count of that run; then a staged timing of one
   render (by CUDA events, then with each stage alone between
   synchronisations), K1 against its twin at the full-size shapes, the
   plain model's estimate of the share of its (row, warp) pairs that a
   warp walks (the plain footprint over the mapping; also on phase 2's
   heavy mapping), and K1's floor probe
   bit for bit against its plain version, timed beside K1.
4. Five training steps at full size, one pose each:
   ``render_with_heuristics`` (SH 3, tiled masked L2 loss, visibility and
   point heuristics) and a ``VisibilityAwareAdam`` step on the SH
   features, checked for zero overflow, finite loss and gradients,
   visibility >= 0, and K2 launches; then a staged timing of one step (as
   in phase 3) and K2 against its twin at the full-size shapes.
5. The sorted-overlap pipeline's kernels against their twins on the card:
   200k splats at 1024x768 with ``scenes.uniform_scene`` and with
   ``scenes.heavy_scene`` statistics, each mapped on the card by the
   port's ``calibrate_mapper`` + ``map_to_tiles`` (``pipeline="sorted"``):
   K4 in blending, antialias and quantile modes with visibility (image max
   abs <= 1e-4, visibility per row <= 1e-4 * max + 1e-6), K5 in blending,
   antialias and heuristics modes (per column <= 1e-4 * max |twin column|
   + 1e-6), K6 bit for bit, K7 reading the gradient rows through the
   point-id order at C 12, 1 and 21 (per column <= 1e-5 * max + 1e-6
   against its twin, and bit for bit against the unfused call on the
   gathered rows and a second run), ``row_gather`` bit for bit with
   indices outside the table; K4 and
   K5 (all three modes) again at 64 features and at ``tile_size`` 4; K5
   twice on the same inputs, printing the largest difference between its
   two runs (its shared atomics sum in a varying order); and one
   small 3D scene mapped on the card and on the CPU (identical integer
   fields) and trained one sorted ``render_with_heuristics`` step on each
   (equal loss to 1e-4 relative).
6. The sorted pipeline at full size: the phase-3 scene with
   ``pipeline="sorted"`` and capacities from the port's
   ``calibrate_mapper`` (max over the five poses): three
   ``render_gaussians`` requests (the last with the median pass, which
   takes the gather fallback) and three training steps as in phase 4
   (flat masked L2 loss: the sorted pipeline has no tiled output), checked
   for zero overflow, finite images, loss and gradients, weights in
   [0, 1 + 1e-6] and visibility >= 0, with the launches of K4-K7 per
   render and per step and one sort of the point ids per step (the
   visibility reduce and the backward share it); staged timings of a
   render and a step; K4-K7 against their twins (K7 also on the
   visibility rows) and K6 / K7 against one PyTorch call at the
   full-size shapes, where K6, K7, torch indexing and ``index_add_`` are
   each timed as calls (CUDA events over 5 back-to-back calls) and by
   device time (the kernels' own time under ``torch.profiler`` over 20
   calls, so that a kernel of tens of microseconds is not judged by its
   Python wrapper); and, for information, the sorted image against the
   stream image of the same pose (the stream pipeline composites in 14-bit
   depth order, the sorted one in exact f32 depth order).  For K4, what
   phase 3 gives for K1: the walked share (also on phase 5's heavy
   mapping) and the floor probe, the counterpart of
   ``benchmarks/exp_kernel_floor.py:_floor_kernel``.  The backward
   reduce is checked to call no ``torch.searchsorted`` and to allocate
   less than half the gradient rows' bytes (no sorted copy), and each
   part of the reduce is timed alone (``reduce_split``: the point ids,
   their sort, and K7 through the order at C 12 and 1).  The row-gather
   probe (``layout.row_gather``, the counterpart of
   ``benchmarks/exp_gather.py``'s gathers) is timed beside torch
   indexing at the reduce's shape and at the probe's defaults.  Device
   times come from profiler sessions that recorded every kernel of every
   call (``device_split``).
7. Multi-device paths on 4 virtual shards of the one card (a mesh that
   lists ``cuda:0`` four times: no interconnect is measured).  At phase
   2's 200k mappings (uniform, heavy at 2 and 32 slabs; 48 bands, 12 a
   shard): K1 with ``band0`` against its twin (TOL) and bit for bit the
   unsharded image's bands, K2 in halo mode against its twin per column
   (heuristics), the halo merge bit for bit its plain twin, no row in a
   halo band outside the image; K1 and K2 at ``band0`` 0 against phase
   2's own outputs (K1 bit for bit, K2 per column).  At the headline (the
   identity pose, phase 4's capacities, 96 bands, 24 a shard):
   ``band_sharded_forward`` and ``band_sharded_grad`` once from zeroed
   counts (their K1, K2 and halo-merge launches), the image bit for bit
   the unsharded K1 image, the per-point gradient against the unsharded
   ``backward_reduce`` per column (K2's gate), peak memory; then the whole
   by CUDA events, each part staged (each shard's K1 and K2, the halo
   exchange, the halo merge, gather + stage 2), each shard's K1 and K2
   as calls beside the unsharded ones, and the halo merge of a middle
   shard as a call, by device time and against its plain twin.  Camera
   data parallelism at the headline: 4 poses on 4 shards
   (``data_parallel_loss``, the SH evaluated once at the identity pose,
   since the reference's data-parallel loss renders (N, C) features):
   loss within 1e-5 relative and visibility within 1e-4 * max + 1e-6 of
   a one-device loop over the same cameras; two ``make_train_step`` steps
   (finite loss, the first equal to the checked loss; ms and peak
   memory); and ``dryrun_multichip(4, devices=[cuda:0] * 4)``.
8. The data-movement probes of ``benchmarks/exp_mosaic.py``
   (``tpu_splatting_torch.benchmarks.exp_mosaic``), on no path: on the
   probes' own inputs each kernel and instantiation bit for bit its twin
   and the probe's expect; then at 12,288 blocks (one per tile of the
   headline at tile 16), each bit for bit its twin, timed by events and by
   device time in turns with what it is compared with: T1 staged against
   direct, T2 against the copy of the reshaped view, T3 against K6
   (``layout.window_copy`` with full counts, also bit for bit), T4's bulk
   copy against per-thread loads; with the twin's time, torch indexing
   (T1, T3), the bound (the rows needed read once, the offsets, the
   output) and the resident warps per SM.
9. The packed-table probes of ``benchmarks/exp_pack.py``
   (``tpu_splatting_torch.benchmarks.exp_pack``), on no path: on the
   probes' own inputs ``unpack_rows`` (U1, U1b, U2) bit for bit its twin
   and the probe's ``x.T``, ``slab_relayout`` and ``column_sums`` the
   twins' zeros on the probes' zero tables; then at scale from a seed,
   each held to its twin and timed from a flushed L2 (device time by
   ``device_split`` without the flush's kernel; a device time below the
   byte bound raises): ``unpack_rows`` at 12,288 blocks of 512 rows (w 16
   and 11 row-major, 12 column-major; bit for bit) against the copy of
   the reshaped view, ``slab_relayout`` over 12,288 slabs (flat C 12,
   packed, flat C 32: the stream table's padded stride; bit for bit, the
   last slab's block) in turns, and ``column_sums`` over 2M rows in 1,953
   blocks at W 11, 12, 32 and packed (250,000, 128) against ``x.sum(0)``
   (within 1e-5 of each column's sum of |x| of the twin, bit for bit a
   second run).
10. The packed-table probes of ``benchmarks/exp_pack2.py``
   (``tpu_splatting_torch.benchmarks.exp_pack2``), on no path: on the
   probes' own inputs each kernel bit for bit its twin and the probe's
   expect (``permuted_unpack`` ``rows.T`` in ``perm_cprime`` order,
   ``repeat_rows`` ``np.tile`` / ``np.repeat``, ``unpack_direct``
   ``rows.T``, ``permute_lanes`` ``x[:, inv]``) and T2's three kernels
   the last slab's block; then at 12,288 blocks from a seed, each bit for
   bit its twin and timed from a flushed L2 beside its byte bound (below
   it raises): the permuted unpack in turns with the direct one, exp_pack's
   staged ``unpack_rows`` and the copies of the views (the H100 answer:
   does the permuted slot order save time?), ``repeat_rows`` with
   ``x.repeat`` / ``repeat_interleave``, ``permute_lanes`` on a
   (12,288, 16, 512) gradient with ``index_select``, and V_a's slab
   relayout in turns with exp_pack's flat and packed ones.
11. The fit-image training path (``tpu_splatting_torch.examples.
   fit_image_gaussians``; ``misc.renderer2d``, ``optim.ParameterClass``,
   ``utils.check_finite``): one ``render_with_heuristics`` 2D step of
   seeded splats on the card against the CPU twins at 48x32 (120 splats)
   and 256x192 (1000): image within TOL, loss within 1e-5, gradients,
   heuristics and visibility within 1e-3 of each one's largest magnitude;
   the trainer at tests/test_fit_image.py's fast config on the card and
   on the CPU from one seed (PSNR > 10 each, within 0.5 dB), its
   converge (> 15) and antialias (> 12) configs on the card; then the
   example's default size (256x192, 1000 splats, 500 iterations, PSNR >
   15) from zeroed counts, with the median step time by CUDA events, the
   splats at the end, and K1's and K2's launches, which must equal the
   steps.
12. The checkpoint-render path (``tpu_splatting_torch.io.ply`` ->
   ``render_gaussians(use_sh=True)``): phase 3's 2M-splat SH-3 scene
   saved with ``save_gaussians`` into a temporary directory (removed at
   the end; the PLY library built with ``g++`` first), read back natively
   and through ``_read_ply_raw_numpy`` (the raw tables equal), loaded onto
   the card both ways (every field bit for bit the scene's), with the
   file's bytes and the seconds to save, to read, to assemble the
   native table into tensors, to load and to copy host to device; the
   identity pose rendered with phase 3's capacities from zeroed counts
   (one K1 launch; its image against phase 3's: bit for bit or within
   TOL, the log says which) and timed by
   ``utils.benchmarked``; ``misc.morton.argsort_morton`` on the 2M
   positions, the card's permutation equal to the CPU's, timed; then the
   examples on the card from zeroed counts: ``render_ply.render`` at
   ``--synthetic 500 --image_size 64,48`` and at its default 1024x768
   with ``--synthetic 100000`` (finite image, weight mean > 0; the
   default overflows its capacities), ``vis_split.main`` (both images
   written) and ``test_backward.main``, with K1's (5) and K2's (1)
   launches, every one of those K1 and K2 calls recorded and held
   against its twin on the same inputs (K1 within TOL, K2 per column);
   then each example again with ``--device cpu`` on the same arguments:
   render_ply's mapping equal but for its float rows (the same windows,
   order and drops), its image difference logged (F8: its f32
   projection differs across the two devices), vis_split's two images
   within TOL, test_backward's loss to 1e-5 relative and each gradient
   to 1e-4 of its largest magnitude.
13. The port's bench (``tpu_splatting_torch.bench`` and its companions in
   ``tpu_splatting_torch.benchmarks``), called as functions, each path's
   K1 / K2 (or K4-K7) launches counted from zero around it: (a) the heavy
   scene at 2M splats, 2048x1536, group width 8, calibrated by the
   bench (its cache under ``tpu_splatting_torch/_build``) and printed
   field by field beside the repository's ``.bench_cal.json``
   ``heavy_gw8_v7`` (and the uniform scene beside ``uniform_gw8_v7``; a
   difference is printed, not failed on), its mapping's overflow [0, 0, 0,
   0, 0], K1 and K2 once against their twins on that mapping (K1 max abs
   <= TOL, K2 per column), the heavy map's device busy share
   (``device_split``), and K1 and K2 against their twins on the uniform
   scene's mapping too; (b) ``bench.run`` at its defaults, its JSON
   line printed on a line of its own and no ``errors``, then one full
   step with its K1 and K2 calls recorded and held against their twins,
   and the step's device busy share; (c) ``bench_4k`` at
   4096x3072: depth_bits 12, 49,152 tiles, overflow 0, K1 and K2 against
   their twins at those shapes, the map and forward + backward times; (d)
   ``bench_components`` at its defaults (K4-K7 each launched, then held
   against their twins on that mapping) and ``bench_stream`` (K1 and K2
   against their twins on its mapping); (e) ``check_card``, every
   quantity PASS, and its card's K1 and K2 calls held against their
   twins.
14. The diagnostic scripts (``tpu_splatting_torch.benchmarks``'
   counterparts of ``benchmarks/profile_*.py`` and ``exp_{mapper,reduce,
   rowgather,layout,precision}.py``), each through its ``main`` on the
   card (``DIAGNOSTICS``: ``profile_map`` and ``profile_map2`` on the
   heavy 2M scene at group width 8 with the bench's cached calibration,
   the rest at their defaults; every script with ``--iters 1 --warmup
   1``, which keeps the phase near 90 s), its lines
   printed and its kernels' launches counted from zero around it; every
   K1 and K2 launch of a script recorded (through ``stream_function`` and
   ``stream_kernels`` alike) and held against its twin on its own inputs
   at the twin gates, launches on equal inputs sharing one twin run;
   K4-K7 held as in phase 13 on ``profile_stages``' rasterizer setup and
   K7 on ``exp_reduce``'s inputs; then the heavy 2M map split by
   ``stream_map`` stage (``profile_map2.stage_split``: marker kernels
   where the call enters a stage; two sessions in a row must agree on
   every stage's kernels), the stages summing to within 10% of the
   call's device time from a whole session of its own, with its busy
   share, and the phase's seconds by script.
15. The profiling modes of K1 and K2 (``stream_kernels``' ``ablate`` and
   ``with_counts``, the reference's instruments), on no path: at phase
   2's 200k uniform mapping every K1 mode (skeleton, the floor probe;
   no_assemble, no_sort, no_alpha), each with and without the counts,
   and the counts of the compositing kernel, against their twins, and
   every K2 mode (skeleton, no_sort, no_grad, no_copyback; heuristics +
   visibility, a random cotangent) against its twin, each at
   ``stream_kernels.profile_gate``'s tolerance (K1's images at TOL,
   no_alpha's faint one per channel at 1e-4 x its largest value, the
   floor probe's bit for bit), the counts exactly; then both of
   ``bench_stream``'s profiles at the reference's 2M scenes
   (``--profile-fwd``, group width 4; ``--profile-bwd``, group width 8),
   printing K1's counts of each mapping, every mode's time by
   ``utils.benchmarked`` and its device span from a flushed L2 (and, for
   K1, its counts), and each difference full - mode with what it
   measures ("not isolated" where the mode changes the walk); the forward
   profile's counts are held against the twin's and its walked share
   against the plain footprint model's (``stream_walk_mask``).  The
   phase's seconds are printed.

The last two lines of standard output are one JSON object with the
kernels' launches, errors, times, bounds and resident warps per SM at the
full shapes (K1 and K2 with their band-sharded launches and errors, the
halo merge with the band-sharded run's launches and its device time,
K6 and K7 with ``device_ms`` and ``library_device_ms`` too, K1 and K2
with their launches on phase 11's default-size run
(``fit_image_launches``) and on phase 12's render of the loaded
checkpoint (``ply_launches``) and its examples (``examples_launches``),
and on phase 13's bench paths (``bench_launches``, by path, and
``bench_max_abs_err``; K4-K7 ``bench_components_launches``), and on
phase 14's scripts (``diagnostics_launches``, by script, and
``diagnostics_max_abs_err``; also K4-K7 and the row-gather probe), and
K1's and K2's ``ablations`` (phase 15: each mode's device span and call
time at the profile scene, its error against its twin, its launches) and
K1's ``with_counts_launches`` and counts,
K5 with its run-to-run difference, and the two floor probes, the
row-gather probe, the four exp_mosaic probes (each second
instantiation's times as fields of their own), the ten exp_pack entries
and the six exp_pack2 entries (one per kernel and width or mode,
``variant`` naming it), which lie on no path:
``main_path`` false, ``launches`` read from their counters after the
main path's run), and
``{"ok": true, "device": ...}``.  The
walked shares of phases 2, 3 and 6 are the plain footprint model's
estimate over the mapping, printed in the log; phase 15's is K1's own
count (``with_counts``), in the kernels line (``profile_counts``).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

TOL = 1e-4          # kernel vs twin, f32, max abs on image + weight
N_SMALL, SIZE_SMALL = 200_000, (1024, 768)
N_FULL, SIZE_FULL = 2_000_000, (2048, 1536)
CAP_KEYS = ("num_slabs", "strip_cap", "slab_cap", "w_max", "run_cap",
            "wide_cap", "dup_cap", "big_tile_window")
HEUR = dict(compute_point_heuristic=True, compute_visibility=True)

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3
PEAK_F32_OPS, PEAK_BYTES = 67e12, 3.35e12
# f32 operations per (row, pixel) pair in blending mode with F = 3, one per
# add, multiply, compare or transcendental.  K1: alpha (6-term quadratic
# form + exp) 11, threshold + clamp 2, exp(lt) 1, weight 1, features 2F,
# weight sum 1, log1p + add 2.  K2 (the pixel-moment form) computes alpha
# from u, v instead (u, v 8, u^2 + v^2 3, scale, exp and pa 3: 14 in place
# of the form's 11) and adds the gradient chain: g.f 2F+1, remaining sum 4,
# alpha_grad 4, z0 2, z0 u and z0 v 2, the four moment products 4 (the
# transform to the six gradients is per row), features F, prune 1, split
# 9, and the pixel reduction of the slabw columns.  K5 is counted alike.
K1_OPS_PER_PAIR = 18 + 2 * 3


def k2_ops_per_pair(slabw):
  return (K1_OPS_PER_PAIR - 11 + 14 + (2 * 3 + 1) + 4 + 4 + 2 + 2 + 4 + 3
          + 1 + 9 + slabw)


def log(msg):
  print(msg, flush=True)


def cuda_ms(fn, reps=3):
  """Mean device time of fn() over reps launches (CUDA events)."""
  fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps


def device_ms(fn, reps=20, kernels=None):
  """Device time of one fn() call, in ms, without the host's work around
  its launches (argument checks, the Python wrapper, the launch itself),
  which cuda_ms's events over back-to-back calls include wherever the
  device waits for the host: the CUDA kernels' own time under
  torch.profiler, summed over reps calls and divided by reps (see
  device_split for ``kernels``)."""
  return sum(device_split(fn, reps, kernels).values())


def device_split(fn, reps=20, kernels=None, attempts=5):
  """{CUDA kernel name: its device ms per fn() call}, under torch.profiler
  over reps calls (``utils.benchmarked.profiled_kernels``).  A profiling
  session on the card's machine now and then loses kernel records (all
  of them, or some), which would read as too short a time.  So a session
  counts only if each kernel name it recorded ran a whole multiple of
  reps times (every call launches the same kernels) and, where the
  caller gives ``kernels`` (the device operations one call launches),
  reps * kernels times in all.  With reps 1 and no ``kernels`` (a step
  that launches many kernels), every count is whole, so a session counts
  once an earlier one recorded the same kernels the same number of
  times: records are lost at random, not alike twice.  A session that
  fails is run again, up to ``attempts`` times; then this raises.  Late
  in a long run, every session lost one record of the 4-microsecond halo
  merge; the spin kernels around the timed calls ended those losses.
  Later still (phase 14), sessions of calls that launch thousands
  of kernels (the heavy map) lost some of their first records, alike in
  consecutive sessions, so that the check above can pass such a session
  a few records short (7 to 35 of 3,151 kernels, 0.1 to 0.5 ms of 36
  ms)."""
  from tpu_splatting_torch.utils.benchmarked import profiled_kernels
  fn()
  torch.cuda.synchronize()
  seen = []
  for _ in range(attempts):
    us, count = profiled_kernels(fn, reps)
    whole = bool(count) and all(k % reps == 0 for k in count.values())
    if kernels is not None:
      whole = whole and sum(count.values()) == reps * kernels
    elif reps == 1:
      whole = whole and count in seen
    if whole:
      return {k: t / reps / 1e3 for k, t in us.items()}
    seen.append(count)
  raise AssertionError(f"torch.profiler lost kernel records in {attempts} "
                       f"sessions of {reps} calls: {seen}")


class Stages:
  """Boundaries of one staged pass.  Each mark() records a CUDA event; the
  gaps between events are stages on the device's timeline, where a stage
  also carries the device's waits for the host's launches.  With
  sync=True each mark() first synchronises and reads the host clock, so
  that each stage is timed alone: its host work and its device work, with
  no overlap with its neighbours."""

  def __init__(self, sync=False):
    self.sync, self.events, self.clock = sync, [], []

  def mark(self):
    if self.sync:
      torch.cuda.synchronize()
      self.clock.append(time.perf_counter())
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    self.events.append(ev)

  def log(self, label, names):
    torch.cuda.synchronize()
    if self.sync:
      ms = [(b - a) * 1e3 for a, b in zip(self.clock, self.clock[1:])]
    else:
      ms = [a.elapsed_time(b) for a, b in zip(self.events, self.events[1:])]
    log(f"  {label} (ms): " + "  ".join(f"{n} {t:.3f}"
                                        for n, t in zip(names, ms)))


def bound_ms(ops, nbytes):
  """(least time in ms, "operations" or "bytes"): the larger of the
  operations over the f32 peak and the bytes over the memory rate."""
  t_ops, t_bytes = ops / PEAK_F32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
  return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def pairs_of(mapping, config):
  """(row, pixel) pairs the mapping's descriptors ask for: the valid
  window rows of every (tile, slab), times the pixels of a tile."""
  from tpu_splatting_torch.rasterizer.stream_kernels import _window_slots
  return int(_window_slots(mapping)[1].sum()) * config.tile_area


def nbytes(*tensors):
  return sum(t.numel() * t.element_size() for t in tensors)


def kernel_vs_twin(mapping, config, label, reps=3):
  """Max abs error of K1 against stream_forward_reference, and both times."""
  from tpu_splatting_torch.rasterizer.stream_kernels import (
      stream_forward, stream_forward_reference)
  got = stream_forward(mapping, config)
  want = stream_forward_reference(mapping, config)
  torch.cuda.synchronize()
  err = float((got - want).abs().max())
  assert torch.isfinite(got).all(), f"{label}: non-finite kernel output"
  k_ms = cuda_ms(lambda: stream_forward(mapping, config), reps)
  t_ms = cuda_ms(lambda: stream_forward_reference(mapping, config), 1)
  log(f"  {label}: max_abs_err {err:.3e} (tol {TOL:g})  kernel {k_ms:.3f} ms"
      f"  twin {t_ms:.3f} ms")
  assert err <= TOL, f"{label}: kernel disagrees with its twin ({err})"
  return err, k_ms, t_ms


def floor_vs_plain(name, fn, plain, args, in_bytes, label):
  """A floor probe bit for bit against its plain version, both timed
  (5 calls each): its kernels-line entry, without the source fields."""
  got = fn(*args)
  want = plain(*args)
  torch.cuda.synchronize()
  assert torch.equal(got, want), (
      f"{label}: {name} differs from its plain version")
  k_ms = cuda_ms(lambda: fn(*args), 5)
  p_ms = cuda_ms(lambda: plain(*args), 5)
  b_ms, b_by = bound_ms(0, in_bytes + nbytes(got))
  log(f"  {label} {name}: bit-exact against its plain version; "
      f"{k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
  return {"main_path": False, "max_abs_err": 0.0, "ms": k_ms,
          "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
          "library_ms": None}


def stream_walk_mask(mapping, config):
  """(R, W) bool over the R window rows of every (tile, slab) that K1
  stages and the W warps of a K1 block: whether the plain footprint
  (``footprint_reference``) of the row meets the warp's pixels.  Antialias
  mode walks every row."""
  from tpu_splatting_torch.rasterizer import kernels as kk
  from tpu_splatting_torch.rasterizer import stream_kernels as sk
  from tpu_splatting_torch.utils.cuda_build import block_threads
  t, s, w = mapping.num_tiles, mapping.num_slabs, mapping.w_max
  ts = config.tile_size
  dev = mapping.table.device
  rpb = mapping.rows_per_block
  table = mapping.table.reshape(-1, mapping.table.shape[1] // rpb)
  lens = sk._staged_lengths(mapping).reshape(-1)
  starts = sk._window_slots(mapping)[2].reshape(-1)[lens > 0]
  tiles = torch.arange(t, device=dev).repeat_interleave(s * w)[lens > 0]
  lens = lens[lens > 0]
  first = torch.cumsum(lens, 0) - lens
  idx = (torch.repeat_interleave(starts - first, lens)
         + torch.arange(int(lens.sum()), device=dev))
  rows = table[idx]
  wr = kk.warp_rects(ts, block_threads(config.tile_area), centred=True)
  if config.antialias:
    return rows.new_ones((rows.shape[0], wr.shape[0]), dtype=torch.bool)
  tiles = torch.repeat_interleave(tiles, lens)
  ox = ((tiles % mapping.tiles_wide) * ts).to(rows.dtype) + ts * 0.5
  oy = ((tiles // mapping.tiles_wide) * ts).to(rows.dtype) + ts * 0.5
  coeffs = kk.quad_coeffs(rows[:, 0] - ox, rows[:, 1] - oy, rows[:, 2],
                          rows[:, 3], rows[:, 4], rows[:, 5], rows[:, 6])
  return kk.walk_mask(kk.footprint_reference(
      coeffs, config.alpha_threshold, ts * 0.5 - 0.5), wr)


def sorted_walk_mask(sorted_rows, chunk_src, chunk_cnt, chunk_to_tile,
                     config, num_tiles, tiles_wide):
  """(R, W) bool over the R valid rows of the tiles' chunks (chunk order)
  and the W warps of a K4 block: whether the plain footprint of the row
  meets the warp's pixels.  Antialias mode walks every row."""
  from tpu_splatting_torch.rasterizer import kernels as kk
  from tpu_splatting_torch.utils.cuda_build import block_threads
  g, ts = config.chunk_size, config.tile_size
  r = torch.arange(g, device=sorted_rows.device)
  keep = ((r < chunk_cnt[:, None])
          & (chunk_to_tile < num_tiles)[:, None])
  rows = sorted_rows[(chunk_src.long()[:, None] + r)[keep]]
  tiles = chunk_to_tile.long()[:, None].expand(-1, g)[keep]
  wr = kk.warp_rects(ts, block_threads(config.tile_area), centred=False)
  if config.antialias:
    return rows.new_ones((rows.shape[0], wr.shape[0]), dtype=torch.bool)
  ox = ((tiles % tiles_wide) * ts).to(rows.dtype)
  oy = ((tiles // tiles_wide) * ts).to(rows.dtype)
  coeffs = kk.quad_coeffs(rows[:, 0] - ox, rows[:, 1] - oy, rows[:, 2],
                          rows[:, 3], rows[:, 4], rows[:, 5], rows[:, 6])
  return kk.walk_mask(kk.footprint_reference(
      coeffs, config.alpha_threshold, ts - 0.5), wr)


def walked_share(mask, label):
  """The plain model's estimate of a forward kernel's walked share:
  (row, warp) pairs whose footprint meets the warp over the pairs the
  mapping gives it (``mask`` from ``stream_walk_mask`` or
  ``sorted_walk_mask``).  The kernel does not count what it walks; this
  is not a device measurement and stays out of the kernels line."""
  share = float(mask.double().mean())
  log(f"  {label} walked share (plain model's estimate, not measured on "
      f"the device): {share:.4f} ({int(mask.sum())} of {mask.shape[0]} "
      f"rows x {mask.shape[1]} warps)")


def backward_vs_twin(mapping, config, label, reps=3):
  """K2 against stream_backward_reference on one cotangent, column by
  column (max |kernel - twin| <= 1e-4 * max |twin column| + 1e-6).
  Returns (max abs error, kernel ms, twin ms)."""
  from tpu_splatting_torch.rasterizer.stream_kernels import (
      stream_backward, stream_backward_reference, stream_forward)
  img = stream_forward(mapping, config)
  gen = torch.Generator(device=img.device).manual_seed(5)
  gimg = torch.randn(img.shape, generator=gen, device=img.device)
  want = stream_backward_reference(mapping, img, gimg, config)
  t_ms = cuda_ms(lambda: stream_backward_reference(mapping, img, gimg,
                                                   config), 1)
  tol_col = 1e-4 * want.abs().amax(0) + 1e-6
  got = stream_backward(mapping, img, gimg, config)
  torch.cuda.synchronize()
  assert torch.isfinite(got).all(), f"{label}: non-finite kernel output"
  err_col = (got - want).abs().amax(0)
  err = float(err_col.max())
  k_ms = cuda_ms(lambda: stream_backward(mapping, img, gimg, config), reps)
  log(f"  {label} K2: max_abs_err {err:.3e}, worst column at "
      f"{float((err_col / tol_col).max()):.3f} of its tolerance  kernel "
      f"{k_ms:.3f} ms  twin {t_ms:.3f} ms")
  assert bool((err_col <= tol_col).all()), (
      f"{label}: K2 disagrees with its twin", err_col.tolist(),
      tol_col.tolist())
  return err, k_ms, t_ms


SOURCES = {"K1": "stream_forward.cu", "K2": "stream_backward.cu",
           "K4": "sorted_forward.cu", "K5": "sorted_backward.cu",
           "K6, K7, row_gather": "layout.cu",
           "T1-T4 (exp_mosaic probes)": "exp_mosaic.cu",
           "U1-U2, T1, F1 (exp_pack probes)": "exp_pack.cu",
           "V_a-V_p, T2 (exp_pack2 probes)": "exp_pack2.cu"}
# f32 operations per (row, pixel) pair of the sorted forward (K4): K1's
# count plus the visibility sum; K5: K2's count for its 7 + F + 2 columns
K4_OPS_PER_PAIR = K1_OPS_PER_PAIR + 1


def entry_label(ptxas_line):
  """'stream_backward_kernel<6, 16>' from ptxas's mangled name in its
  'Compiling entry function' line (or a SASS 'Function :' line)."""
  m = re.search(r"\d([A-Za-z_]+_kernel)I(.+?)EEv", ptxas_line)
  if m is None:
    m = re.search(r"\d([A-Za-z_]+_kernel)E", ptxas_line)
    return m.group(1) if m else ptxas_line.strip()
  args = [v if k == "i" else ("true" if v == "1" else "false")
          for k, v in re.findall(r"L([ib])(\d+)E", m.group(2))] or [
      {"j": "uint32", "m": "uint64", "f": "float", "d": "double"}.get(
          m.group(2), m.group(2))]
  return f"{m.group(1)}<{', '.join(args)}>"


def sass_functions(lib):
  """{kernel label: its SASS lines} of a built library (``cuobjdump
  -sass``)."""
  import shutil
  tool = next((c for c in (shutil.which("cuobjdump"),
                           "/usr/local/cuda/bin/cuobjdump")
               if c and os.path.exists(c)), None)
  assert tool, "cuobjdump not found"
  sass = subprocess.run([tool, "-sass", lib._name], capture_output=True,
                        text=True, check=True).stdout
  functions, name = {}, None
  for line in sass.splitlines():
    if "Function :" in line:
      name = entry_label(line)
      functions[name] = []
    elif name is not None:
      functions[name].append(line)
  return functions


def sass_counts(lib):
  """{kernel label: (global loads, shared stores)} in the SASS of a built
  library."""
  return {name: [sum(bool(re.search(p, line)) for line in lines)
                 for p in (r"\bLDG\b", r"\bSTS\b")]
          for name, lines in sass_functions(lib).items()}


def check_bulk_sass():
  """T3's kernel and T4's bulk instantiation still issue a bulk
  asynchronous copy (a UBLK* / UTMA* opcode in their SASS), and T4's
  per-thread-copies instantiation issues none.  Returns {kernel: the
  opcodes found}."""
  from tpu_splatting_torch.benchmarks import exp_mosaic as em
  functions = sass_functions(em._kernel())
  found = {k: sorted({m.group(1) for line in functions[k]
                      for m in [re.search(r"\b((?:UBLK|UTMA)[A-Z0-9_.]*)",
                                          line)] if m})
           for k in ("double_block_window_kernel",
                     "dma_residue_sum_kernel<true>",
                     "dma_residue_sum_kernel<false>")}
  log(f"  bulk-copy opcodes in the SASS: {found}")
  assert found["double_block_window_kernel"], found
  assert found["dma_residue_sum_kernel<true>"], found
  assert not found["dma_residue_sum_kernel<false>"], found
  return found


def check_floor_sass():
  """The floor probes' staging survived the compiler: their SASS keeps the
  row loads from global memory and the stores of the staged rows to
  shared memory (printed beside the compositing kernel's)."""
  from tpu_splatting_torch.rasterizer import kernels as kk
  from tpu_splatting_torch.rasterizer import stream_kernels as sk
  for lib, stem, width in ((sk._kernel(), "stream_forward", sk.FLOOR_WIDTH),
                           (kk._fwd_kernel(), "sorted_forward",
                            kk.FLOOR_WIDTH)):
    counts = sass_counts(lib)
    floor = counts[f"{stem}_headline_kernel<{width}, false>"]
    walk = counts[f"{stem}_headline_kernel<{width}, true>"]
    log(f"  SASS of {stem}_headline_kernel<{width}>: floor probe {floor[0]} "
        f"global loads, {floor[1]} shared stores; compositing kernel "
        f"{walk[0]} and {walk[1]}")
    assert floor[0] >= 8 and floor[1] >= 7, (stem, floor)


# the headline's shapes (PERF.md section 4): F 3 with heuristics, tile 16,
# stream slab_cap 512 and w_max 27, sorted chunk 128
HEADLINE = dict(f=3, tile_area=256, slab_cap=512, w_max=27, chunk=128)


def kernel_plans(f, tile_area, slab_cap, w_max, chunk, heur=True):
  """{kernel: (library, C entry stem, plan, the C *_smem arguments but the
  plan's)} of K1, K2, K4 and K5 at these shapes."""
  from tpu_splatting_torch.rasterizer import kernels as kk
  from tpu_splatting_torch.rasterizer import stream_kernels as sk
  slabw = 7 + f + (3 if heur else 0)
  out_w = 7 + f + (2 if heur else 0)
  return {
      "K1": (sk._kernel(), "tpu_splat_stream_forward",
             sk.stream_forward_plan(f, slab_cap, w_max, tile_area),
             (slab_cap, w_max, f)),
      "K2": (sk._bwd_kernel(), "tpu_splat_stream_backward",
             sk.stream_backward_plan(f, slab_cap, w_max, slabw, tile_area),
             (slab_cap, w_max, f, slabw)),
      "K4": (kk._fwd_kernel(), "tpu_splat_sorted_forward",
             kk.sorted_forward_plan(f, chunk, tile_area), (chunk, f)),
      "K5": (kk._bwd_kernel(), "tpu_splat_sorted_backward",
             kk.sorted_backward_plan(f, chunk, out_w, tile_area),
             (chunk, f, out_w))}


# tpu_splat_layout_occupancy's kernel numbers
LAYOUT_KERNELS = {"K6": 0, "K7": 1, "K7 bounds": 2, "row_gather": 3}


def occupancy_of(name, plan=None):
  """Resident blocks and warps per SM, registers and local bytes of a
  kernel: K1, K2, K4, K5 at a plan, the layout kernels (K6, K7's bounds
  pass and sum, row_gather) as they launch (f32 rows,
  256 threads, no shared memory)."""
  import ctypes
  from tpu_splatting_torch.rasterizer import layout
  from tpu_splatting_torch.utils.cuda_build import occupancy
  if name in LAYOUT_KERNELS:
    out = (ctypes.c_int * 3)()
    err = layout._kernel().tpu_splat_layout_occupancy(
        LAYOUT_KERNELS[name], 4, 256, out)
    assert err == 0, err
    return {"blocks_per_sm": out[0], "warps_per_sm": out[0] * 8,
            "registers": out[1], "local_bytes": out[2]}
  lib, stem, plan0, _ = kernel_plans(**HEADLINE)[name]
  return occupancy(lib, stem, plan or plan0)


def phase_plans():
  """Occupancy of every kernel at the headline shapes, and the plans'
  shared-memory formulas against the C entries'."""
  occ = {}
  for name in ("K1", "K2", "K4", "K5", *LAYOUT_KERNELS):
    occ[name] = occupancy_of(name)
    plan = (kernel_plans(**HEADLINE)[name][2]
            if name not in LAYOUT_KERNELS else None)
    log(f"  {name} at the headline shapes: "
        + (f"instantiation {plan.max_features}, {plan.threads} threads, "
           f"{plan.smem} B of shared memory; " if plan else
           "256 threads, no shared memory; ")
        + f"{occ[name]['registers']} registers, {occ[name]['local_bytes']} "
        f"local bytes, {occ[name]['blocks_per_sm']} blocks = "
        f"{occ[name]['warps_per_sm']} warps resident per SM")
  checked = 0
  for f in (3, 6, 7, 8, 22, 23, 24, 56, 57, 64, 100):
    for tile_area in (16, 64, 256, 1024):
      for slab_cap, chunk in ((128, 32), (512, 128), (1792, 128)):
        for name, (lib, stem, plan, args) in kernel_plans(
            f, tile_area, slab_cap, 27, chunk).items():
          c_smem = getattr(lib, f"{stem}_smem")(*args, plan.max_features,
                                                plan.threads)
          assert c_smem == plan.smem, (name, f, tile_area, plan, c_smem)
          checked += 1
  log(f"  plan shared memory equals the C *_smem entries at {checked} "
      "shapes (F 3-100, tiles of 16-1024 pixels)")
  return occ


def phase_device():
  if not torch.cuda.is_available():
    raise SystemExit("chip_smoke: CUDA is not available")
  smi = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True, check=True)
  card = smi.stdout.strip().splitlines()[0]
  log(f"card: {card}")
  log(f"torch {torch.__version__} cuda {torch.version.cuda} "
      f"device {torch.cuda.get_device_name(0)}")
  from tpu_splatting_torch.utils.cuda_build import (build_info,
                                                    load_kernel_libraries)
  t0 = time.perf_counter()
  sources = tuple(SOURCES.values())
  load_kernel_libraries(sources)
  log(f"build of {sources} in parallel: {time.perf_counter() - t0:.2f} s")
  for name, src in SOURCES.items():
    info = build_info[src]
    log(f"{name} build ({src}): {info['seconds']:.2f} s")
    for line in info["log"].splitlines():
      if "Compiling entry function" in line:
        log(f"  {entry_label(line)}")
      elif "registers" in line or "spill" in line:
        log(f"    ptxas: {line.strip()}")
  check_floor_sass()
  check_bulk_sass()
  return card, phase_plans()


def wide_features(n, num_features):
  """(n, num_features) f32 features in [0, 1), from a seed."""
  return np.random.default_rng(11).uniform(
      0.0, 1.0, (n, num_features)).astype(np.float32)


def mapped_scene(packed, depth, feats, image_size, config, dev,
                 slab_cap=512):
  from tpu_splatting_torch import calibrate_stream, stream_map
  p = torch.from_numpy(packed).to(dev)
  d = torch.from_numpy(depth).to(dev)
  f = torch.from_numpy(feats).to(dev)
  t0 = time.perf_counter()
  cal = calibrate_stream(p, d, f, image_size, config, group_width=8,
                         slab_cap=slab_cap)
  cfg = dataclasses.replace(config, big_tile_window=cal["big_tile_window"])
  caps = {k: cal[k] for k in ("num_slabs", "strip_cap", "slab_cap", "w_max",
                              "run_cap", "wide_cap", "dup_cap")}
  torch.cuda.synchronize()
  log(f"  calibration {time.perf_counter() - t0:.2f} s: {caps} "
      f"dup rows {cal['num_dup_rows']}")

  def build(features):
    m = stream_map(p, d, features, image_size, cfg, group_width=8, **caps)
    assert int(m.num_overflow) == 0, m.overflow.tolist()
    return m
  return cfg, build, f, d


def mapping_to(m, dev):
  """The mapping with every tensor field on ``dev``."""
  return dataclasses.replace(m, **{
      f.name: getattr(m, f.name).to(dev) for f in dataclasses.fields(m)
      if isinstance(getattr(m, f.name), torch.Tensor)})


def phase_twin(dev):
  """Phases 2 and 2b: (K1 max error, K2 max error, the 200k mappings for
  phase 7 as (label, mapping, config), phase 2's K1 image and K2 buffer of
  the uniform mapping as (image, cotangent, K2 buffer)).  What phase 7
  takes is kept in host memory, out of phases 3-6's device peaks."""
  from tpu_splatting_torch import RasterConfig
  from tpu_splatting_torch.rasterizer import stream_kernels as sk
  from tpu_splatting_torch.scenes import heavy_scene, uniform_scene
  errs, errs2 = [], []
  log(f"phase 2: K1 and K2 vs twins, uniform {N_SMALL} splats {SIZE_SMALL}")
  scene = uniform_scene(np.random.default_rng(0), N_SMALL, SIZE_SMALL)
  cfg, build, feats, depth = mapped_scene(*scene, SIZE_SMALL,
                                          RasterConfig(), dev)
  m = build(feats)
  errs.append(kernel_vs_twin(m, cfg, "blending")[0])
  shard_checks = [("uniform", mapping_to(m, "cpu"), cfg)]
  img = sk.stream_forward(m, cfg)
  gimg = torch.randn(img.shape, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(6))
  phase2_out = tuple(x.cpu() for x in (img, gimg, sk.stream_backward(
      m, img, gimg, dataclasses.replace(cfg, **HEUR))))
  errs.append(kernel_vs_twin(
      m, dataclasses.replace(cfg, antialias=True), "antialias")[0])
  mq = build(depth[:, None])
  errs.append(kernel_vs_twin(
      mq, dataclasses.replace(cfg, use_alpha_blending=False,
                              saturate_threshold=0.25), "quantile")[0])
  for label, extra in (("blending", {}), ("antialias", dict(antialias=True)),
                       ("heuristics + visibility", HEUR)):
    errs2.append(backward_vs_twin(
        m, dataclasses.replace(cfg, **extra), label)[0])

  # heavy statistics twice: slab_cap > 512, and many thin slabs (the
  # carry across slabs); both with wide-splat duplication
  scene = heavy_scene(np.random.default_rng(1), N_SMALL, SIZE_SMALL)
  for slab_cap in (1024, 128):
    log(f"phase 2: K1 and K2 vs twins, heavy statistics {N_SMALL} splats, "
        f"calibrated from slab_cap {slab_cap}")
    cfg, build, feats, _ = mapped_scene(*scene, SIZE_SMALL, RasterConfig(),
                                        dev, slab_cap=slab_cap)
    m = build(feats)
    shard_checks.append((f"heavy {m.num_slabs} slabs", mapping_to(m, "cpu"),
                         cfg))
    log(f"  heavy mapping: slab_cap {m.slab_cap} num_slabs {m.num_slabs} "
        f"w_max {m.w_max} dup_cap {m.dup_cap}")
    errs.append(kernel_vs_twin(m, cfg, "heavy blending", reps=1)[0])
    if slab_cap == 1024:
      walked_share(stream_walk_mask(m, cfg), "heavy K1")
    errs2.append(backward_vs_twin(
        m, dataclasses.replace(cfg, **HEUR), "heavy heuristics", reps=1)[0])

  # the heavy scene's calibration at 2M splats asks for slab_cap 1792:
  # K2 must still fit one block's shared memory there at F = 3 with
  # heuristics (13 columns; w_max as in the 32-slab mapping above)
  from tpu_splatting_torch.utils.cuda_build import SMEM_LIMIT
  smem = sk.stream_backward_plan(3, 1792, m.w_max, 13, 256).smem
  log(f"  K2 shared memory at slab_cap 1792, w_max {m.w_max}, F 3, 13 "
      f"columns: {smem} B of {SMEM_LIMIT}")
  assert smem <= SMEM_LIMIT, smem

  # past the headline: 64 features (the generic instantiations; slabs of
  # 128 rows, which K2's shared memory holds at that width) and 16-pixel
  # tiles (half a warp: the block is padded with frozen lanes)
  scene = uniform_scene(np.random.default_rng(0), N_SMALL, SIZE_SMALL)
  wide = wide_features(N_SMALL, 64)
  for num_f, ts in ((64, 16), (3, 4), (64, 4)):
    log(f"phase 2: K1 and K2 vs twins, uniform {N_SMALL} splats "
        f"{SIZE_SMALL}, {num_f} features, tile_size {ts}")
    feats = wide if num_f == 64 else scene[2]
    cfg, build, f_dev, _ = mapped_scene(
        scene[0], scene[1], feats, SIZE_SMALL, RasterConfig(tile_size=ts),
        dev, slab_cap=128 if num_f == 64 else 512)
    m = build(f_dev)
    plans = kernel_plans(num_f, cfg.tile_area, m.slab_cap, m.w_max, 128)
    log(f"  mapping: slab_cap {m.slab_cap} num_slabs {m.num_slabs} w_max "
        f"{m.w_max}; plans K1 {tuple(plans['K1'][2])} K2 "
        f"{tuple(plans['K2'][2])}")
    errs.append(kernel_vs_twin(m, cfg, f"F {num_f} tile {ts} blending",
                               reps=1)[0])
    errs2.append(backward_vs_twin(
        m, dataclasses.replace(cfg, **HEUR),
        f"F {num_f} tile {ts} heuristics", reps=1)[0])
  return max(errs), max(errs2), shard_checks, phase2_out


def cross_device_check(dev):
  """A small 3D scene rendered on the card, and its projected splats
  mapped and composited on the CPU: the mapper's integer fields and table
  must be identical; the images agree to TOL except where an a_raw lies
  within an ulp of alpha_threshold (CPU and CUDA exp differ by an ulp),
  which moves a pixel by at most alpha_threshold."""
  from tpu_splatting_torch import RasterConfig, render_gaussians
  from tpu_splatting_torch.perspective.projection import (ndc_depth,
                                                          project_to_image)
  from tpu_splatting_torch.rasterizer.stream_function import (
      stream_map_with_config)
  from tpu_splatting_torch.renderer import render_projected
  from tpu_splatting_torch.benchmarks.check_card import mapping_differences
  from tpu_splatting_torch.scenes import lift_to_3d, uniform_scene
  from tpu_splatting_torch.spherical_harmonics import evaluate_sh_at
  size = (256, 192)
  packed, depth, feats = uniform_scene(np.random.default_rng(2), 20_000,
                                       size)
  cfg = RasterConfig(stream_num_slabs=4, stream_strip_cap=4096,
                     stream_slab_cap=1024, stream_w_max=72,
                     stream_run_cap=512, stream_wide_cap=1024,
                     stream_dup_cap=8192)
  g3d, cam = lift_to_3d(packed, depth, feats, size, near=0.1, far=100.0,
                        fov_deg=70.0, device=dev)
  with torch.no_grad():
    r = render_gaussians(g3d, cam, cfg, use_sh=True)
    assert int(r.num_overflow) == 0, r.overflow_by_cause.tolist()
    g2d, depths, in_view = project_to_image(g3d, cam, cfg)
    sh = evaluate_sh_at(g3d.feature, g3d.position, cam.camera_position)
    nd = torch.where(depths > 0,
                     ndc_depth(depths, cam.near_plane, cam.far_plane), 0.0)
    maps = [stream_map_with_config(g2d.to(d), nd.to(d), sh.to(d), size, cfg)
            for d in (dev, "cpu")]
    r_cpu = render_projected(in_view.cpu(), g2d.cpu(), sh.cpu(),
                             depths.cpu(), cam.to("cpu"), cfg)
  differ = mapping_differences(*maps)
  assert not differ, f"mapper differs between card and CPU: {differ}"
  err = torch.cat([(r.image.cpu() - r_cpu.image).abs().flatten(),
                   (r.image_weight.cpu() - r_cpu.image_weight).abs()
                   .flatten()])
  frac = float((err > TOL).float().mean())
  log(f"  small render {size}: mapper identical on card and CPU; image "
      f"max_abs_err {float(err.max()):.3e}, share above {TOL:g}: {frac:.2e}")
  assert float(err.max()) <= cfg.alpha_threshold + TOL, float(err.max())
  assert frac <= 1e-3, frac

  # one training step of the same scene on the card (kernels) and on the
  # CPU (twins): the loss, every leaf's gradient and the heuristics agree
  # but for the few points an exp ulp flips at alpha_threshold
  from tpu_splatting_torch import render_with_heuristics
  hcfg = dataclasses.replace(cfg, **HEUR)
  tgt = torch.from_numpy(np.random.default_rng(7).random(
      (size[1], size[0], 3)).astype(np.float32))
  steps = []
  for d in (dev, "cpu"):
    t = tgt.to(d)
    g_d = g3d.replace(**{f.name: getattr(g3d, f.name).to(d)
                         for f in dataclasses.fields(g3d)})
    steps.append(render_with_heuristics(
        lambda r, t=t: ((r.image - t) ** 2).sum(), g_d, cam.to(d), hcfg,
        use_sh=True))
  (l_gpu, r_gpu, g_gpu), (l_cpu, r_cpu, g_cpu) = steps
  assert abs(float(l_gpu) - float(l_cpu)) <= 1e-4 * abs(float(l_cpu))
  shares = {}
  for name in ("position", "log_scaling", "rotation", "alpha_logit",
               "feature", "visibility", "prune_cost", "split_score"):
    src = (g_gpu, g_cpu) if hasattr(g_cpu, name) else (r_gpu.points,
                                                       r_cpu.points)
    a, b = getattr(src[0], name).cpu(), getattr(src[1], name)
    assert torch.isfinite(a).all(), name
    off = (a - b).abs() > 1e-3 * b.abs().max() + 1e-6
    shares[name] = float(off.float().mean())
    assert shares[name] <= 1e-3, (name, shares[name])
  log(f"  small training step {size}: loss card {float(l_gpu):.6f} CPU "
      f"{float(l_cpu):.6f}; share of entries off by > 1e-3 of the "
      f"largest: {max(shares.values()):.2e}")
  return float(err.max())


def poses(dev):
  """Identity plus four small camera translations."""
  out = []
  for dx, dy in ((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1)):
    t = torch.eye(4, dtype=torch.float32, device=dev)
    t[0, 3], t[1, 3] = 1e-3 * dx, 1e-3 * dy
    out.append(t)
  return out


def headline_scene(dev):
  """The headline's 2M splats lifted to 3D, and the five poses' cameras."""
  from tpu_splatting_torch.scenes import lift_to_3d, uniform_scene
  packed, depth, feats = uniform_scene(np.random.default_rng(0), N_FULL,
                                       SIZE_FULL)
  g3d, cam0 = lift_to_3d(packed, depth, feats, SIZE_FULL, near=0.1,
                         far=100.0, fov_deg=70.0, device=dev)
  return g3d, [cam0.replace(T_camera_world=t) for t in poses(dev)]


def phase_full(dev):
  from tpu_splatting_torch import RasterConfig, calibrate_stream
  from tpu_splatting_torch.perspective.projection import (ndc_depth,
                                                          project_to_image)
  from tpu_splatting_torch.rasterizer import stream_kernels as sk
  from tpu_splatting_torch.rasterizer.stream_function import (
      detile, stream_map_with_config)
  from tpu_splatting_torch.renderer import render_gaussians
  from tpu_splatting_torch.spherical_harmonics import evaluate_sh_at

  log(f"phase 3: {N_FULL} splats {SIZE_FULL} SH degree 3")
  g3d, cams = headline_scene(dev)
  base = RasterConfig(stream_group_width=8)

  # size the static capacities for every pose (max over poses)
  t0 = time.perf_counter()
  caps = {}
  with torch.no_grad():
    for i, cam in enumerate(cams):
      g2d, depths, _ = project_to_image(g3d, cam, base)
      nd = torch.where(depths > 0,
                       ndc_depth(depths, cam.near_plane, cam.far_plane), 0.0)
      feats = evaluate_sh_at(g3d.feature, g3d.position,
                             cam.camera_position)
      cal = calibrate_stream(g2d, nd, feats, SIZE_FULL, base, group_width=8)
      for k in CAP_KEYS:
        caps[k] = max(caps.get(k, 0), cal[k])
      if i == 0:
        log(f"  identity-pose caps: { {k: cal[k] for k in CAP_KEYS} } "
            f"max strip rows {cal['max_strip_rows']} max run "
            f"{cal['max_run']} max slab rows {cal['max_slab_rows']}")
      del g2d, depths, nd, feats
  torch.cuda.synchronize()
  log(f"  calibration (5 poses): {time.perf_counter() - t0:.2f} s")
  log(f"  port caps (max over poses): {caps}")
  ref_cal_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              ".bench_cal.json")
  with open(ref_cal_path) as fh:
    ref = json.load(fh).get("uniform_full_gw8_v7", {})
  log(f"  reference (JAX) caps of the identity pose, for information: "
      f"{ {k: ref.get(k) for k in caps} } max strip rows "
      f"{ref.get('max_strip_rows')} max run {ref.get('max_run')} max slab "
      f"rows {ref.get('max_slab_rows')}")
  cfg = dataclasses.replace(
      base, stream_num_slabs=caps["num_slabs"],
      stream_strip_cap=caps["strip_cap"], stream_slab_cap=caps["slab_cap"],
      stream_w_max=caps["w_max"], stream_run_cap=caps["run_cap"],
      stream_wide_cap=caps["wide_cap"], stream_dup_cap=caps["dup_cap"],
      big_tile_window=caps["big_tile_window"])

  # five requests through the public entry point
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  sk.reset_launch_counts()
  times = []
  with torch.no_grad():
    for i, cam in enumerate(cams):
      median = i == len(cams) - 1
      t0 = time.perf_counter()
      r = render_gaussians(g3d, cam, cfg, use_sh=True,
                           render_median_depth=median)
      torch.cuda.synchronize()
      times.append((time.perf_counter() - t0) * 1e3)
      assert int(r.num_overflow) == 0, (i, r.overflow_by_cause.tolist())
      assert torch.isfinite(r.image).all(), i
      assert torch.isfinite(r.image_weight).all(), i
      w_min, w_max = float(r.image_weight.min()), float(r.image_weight.max())
      assert w_min >= 0.0 and w_max <= 1.0 + 1e-6, (i, w_min, w_max)
      if i == 0:
        image0 = r.image.clone()     # phase 12 renders the same pose again
      if median:
        assert torch.isfinite(r.median_depth_image).all()
      log(f"  request {i}: {times[-1]:.2f} ms  weight in [{w_min:.4f}, "
          f"{w_max:.6f}]  mean rgb {r.image.mean().item():.4f}"
          + ("  (+median pass)" if median else ""))
  launches = sk.launch_counts["stream_forward"]
  floor_launches = sk.probe_launch_counts["stream_forward_floor"]
  peak = torch.cuda.max_memory_allocated() / 2 ** 30
  log(f"  K1 launches in the 5 requests: {launches}; its floor probe's: "
      f"{floor_launches}")
  assert launches >= len(cams), launches
  log(f"  end-to-end ms per render: {[round(t, 3) for t in times]}")
  log(f"  peak device memory: {peak:.3f} GiB")

  # staged timing of one render (same public functions): warm once, then
  # by CUDA events and with each stage alone
  cam = cams[0]
  runs = []
  with torch.no_grad():
    for sync in (False, False, True):
      st = Stages(sync)
      st.mark()
      g2d, depths, _ = project_to_image(g3d, cam, cfg)
      st.mark()
      feats = evaluate_sh_at(g3d.feature, g3d.position, cam.camera_position)
      st.mark()
      nd = torch.where(depths > 0,
                       ndc_depth(depths, cam.near_plane, cam.far_plane), 0.0)
      m = stream_map_with_config(g2d, nd, feats, SIZE_FULL, cfg)
      st.mark()
      it = sk.stream_forward(m, cfg)
      st.mark()
      detile(it, m.tiles_wide, m.tiles_high, cfg.tile_size, SIZE_FULL)
      st.mark()
      runs.append(st)
    names = ("project", "SH", "map", "K1", "detile")
    runs[1].log("stages", names)
    runs[2].log("stages, each alone", names)

    log("  K1 vs twin at the full-size shapes")
    err_b, k_ms, t_ms = kernel_vs_twin(m, cfg, "full blending", reps=5)
    median_cfg = dataclasses.replace(cfg, use_alpha_blending=False,
                                     saturate_threshold=cfg.median_threshold)
    mq = stream_map_with_config(
        g2d, nd, torch.cat([feats, depths], -1), SIZE_FULL, cfg)
    err_q, _, _ = kernel_vs_twin(mq, median_cfg, "full quantile", reps=1)
    walked_share(stream_walk_mask(m, cfg), "K1")
  b_ms, b_by = bound_ms(pairs_of(m, cfg) * K1_OPS_PER_PAIR,
                        nbytes(m.table, m.desc, m.strip_blk, it))
  log(f"  K1 bound at the full-size shapes: {b_ms:.4f} ms ({b_by}; "
      f"{pairs_of(m, cfg)} (row, pixel) pairs)")
  occ1 = occupancy_of("K1", sk.stream_forward_plan(
      m.feature_size, m.slab_cap, m.w_max, cfg.tile_area))
  log(f"  K1 at the full shapes (slab_cap {m.slab_cap}, w_max {m.w_max}): "
      f"{occ1}")
  k1 = {"launches": launches, "max_abs_err": max(err_b, err_q),
        "ms": k_ms, "plain_ms": t_ms, "bound_ms": b_ms, "bound_by": b_by,
        "resident_warps_per_sm": occ1["warps_per_sm"]}
  k1_floor = {"launches": floor_launches, **floor_vs_plain(
      "stream_forward_floor", sk.stream_forward_floor,
      sk.stream_forward_floor_reference, (m, cfg),
      nbytes(m.table, m.desc, m.strip_blk), "full")}
  log(f"  K1 {k_ms:.3f} ms = floor (staging and sort) "
      f"{k1_floor['ms']:.3f} + walk {k_ms - k1_floor['ms']:.3f} ms")
  return k1, k1_floor, g3d, cams, cfg, image0


def phase_train(dev, g3d, cams, cfg_caps):
  """Five full-size training steps, a staged step, K2 at full shapes."""
  from tpu_splatting_torch import render_with_heuristics
  from tpu_splatting_torch.mapper.tile_mapper import tile_shape
  from tpu_splatting_torch.optim import GroupConfig, VisibilityAwareAdam
  from tpu_splatting_torch.perspective.projection import (ndc_depth,
                                                          project_to_image)
  from tpu_splatting_torch.rasterizer import stream_kernels as sk
  from tpu_splatting_torch.rasterizer.stream_function import (
      entile, reduce_stage2, stream_map_with_config,
      stream_rasterize_with_mapping, tile_mask)
  from tpu_splatting_torch.spherical_harmonics import evaluate_sh_at

  cfg = dataclasses.replace(cfg_caps, **HEUR)
  log(f"phase 4: {len(cams)} training steps, {N_FULL} splats {SIZE_FULL} "
      f"SH degree 3, heuristics + visibility")
  tw, th = tile_shape(SIZE_FULL, cfg.tile_size)
  tgt_full = np.random.default_rng(7).random(
      (SIZE_FULL[1], SIZE_FULL[0], 3)).astype(np.float32)
  tgt = entile(torch.from_numpy(tgt_full).to(dev), tw, th, cfg.tile_size)
  mask = tile_mask(SIZE_FULL, tw, th, cfg.tile_size, device=dev)
  del tgt_full

  def loss_fn(rendering):
    err = rendering.image - tgt                  # (T, 3, PIX)
    return (mask * (err * err)).sum()

  # the SH features only: positions, scales and opacities keep their
  # values, so the calibrated capacities stay valid
  opt = VisibilityAwareAdam({"feature": GroupConfig(lr=1e-3)})
  state = opt.init({"feature": g3d.feature})
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  sk.reset_launch_counts()
  times, losses = [], []
  for i, cam in enumerate(cams):
    k2_before = sk.launch_counts["stream_backward"]
    t0 = time.perf_counter()
    loss, r, grads = render_with_heuristics(loss_fn, g3d, cam, cfg,
                                            use_sh=True, tiled=True)
    vis = r.points.visibility
    params, state = opt.step({"feature": g3d.feature},
                             {"feature": grads.feature}, state, vis)
    g3d = g3d.replace(feature=params["feature"])
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) * 1e3)
    losses.append(float(loss))
    assert int(r.num_overflow) == 0, (i, r.overflow_by_cause.tolist())
    assert np.isfinite(losses[-1]), (i, losses[-1])
    for name in ("position", "log_scaling", "rotation", "alpha_logit",
                 "feature"):
      assert torch.isfinite(getattr(grads, name)).all(), (i, name)
    for name in ("prune_cost", "split_score"):
      assert torch.isfinite(getattr(r.points, name)).all(), (i, name)
    assert float(vis.min()) >= 0.0, (i, float(vis.min()))
    assert sk.launch_counts["stream_backward"] > k2_before, i
    log(f"  step {i}: {times[-1]:.2f} ms  loss {losses[-1]:.4f}  visible "
        f"{int((vis > 0).sum())}  |grad position| max "
        f"{float(grads.position.abs().max()):.4e}")
  launches = dict(sk.launch_counts)
  peak = torch.cuda.max_memory_allocated() / 2 ** 30
  log(f"  launches in the {len(cams)} steps: {launches}")
  assert launches["stream_backward"] >= len(cams), launches
  assert launches["stream_forward"] >= len(cams), launches
  log(f"  end-to-end ms per training step: {[round(t, 3) for t in times]}")
  log(f"  peak device memory: {peak:.3f} GiB")

  # staged timing of one step: the same public functions, the backward
  # taken apart (K2, stage 2, autograd tail through SH and projection)
  cam = cams[0]
  names = ("forward", "K2", "reduce stage 2", "autograd tail", "optimizer")
  runs = []
  for sync in (False, False, True):    # warm once, events, each alone
    st = Stages(sync)
    st.mark()
    leaves = [getattr(g3d, f.name).detach().requires_grad_(True)
              for f in dataclasses.fields(g3d)]
    g = g3d.replace(**{f.name: x for f, x in
                       zip(dataclasses.fields(g3d), leaves)})
    g2d, depths, _ = project_to_image(g, cam, cfg)
    feats = evaluate_sh_at(g.feature, g.position.detach(),
                           cam.camera_position)
    nd = torch.where(depths > 0,
                     ndc_depth(depths, cam.near_plane, cam.far_plane), 0.0)
    m = stream_map_with_config(g2d.detach(), nd.detach(), feats.detach(),
                               SIZE_FULL, cfg)
    it = stream_rasterize_with_mapping(g2d, feats, m, SIZE_FULL, cfg,
                                       tiled=True)
    loss = (mask * (it[:, :3] - tgt) ** 2).sum()
    (g_it,) = torch.autograd.grad(loss, it, retain_graph=True)
    st.mark()
    buf = sk.stream_backward(m, it.detach(), g_it, cfg)
    st.mark()
    gcols = reduce_stage2(buf, m)
    st.mark()
    tail = torch.autograd.grad([g2d, feats], leaves,
                               [gcols[:, :7], gcols[:, 7:10]])
    st.mark()
    opt.step({"feature": g3d.feature}, {"feature": tail[4]}, state,
             gcols[:, 10])
    st.mark()
    runs.append(st)
  runs[1].log("step stages", names)
  runs[2].log("step stages, each alone", names)

  log("  K2 vs twin at the full-size shapes")
  err, k_ms, t_ms = backward_vs_twin(m, cfg, "full heuristics", reps=5)
  slabw = sk.slab_width(cfg, m.feature_size)
  pairs = pairs_of(m, cfg)
  b_ms, b_by = bound_ms(
      pairs * k2_ops_per_pair(slabw),
      nbytes(m.table, m.desc, m.strip_blk, it, g_it, buf))
  log(f"  K2 bound at the full-size shapes: {b_ms:.4f} ms ({b_by}; {pairs} "
      f"(row, pixel) pairs, {k2_ops_per_pair(slabw)} operations each)")
  occ2 = occupancy_of("K2", sk.stream_backward_plan(
      m.feature_size, m.slab_cap, m.w_max, slabw, cfg.tile_area))
  log(f"  K2 at the full shapes: {occ2}")
  k2 = {"launches": launches["stream_backward"], "max_abs_err": err,
        "ms": k_ms, "plain_ms": t_ms, "bound_ms": b_ms, "bound_by": b_by,
        "resident_warps_per_sm": occ2["warps_per_sm"]}

  # K3's function on its own: sum every (tile, slab) window row's
  # gradient row into its home-major row.  Its plain version and its one
  # library call are the same index_add_ (the twin's merge step).
  _, lnc, _ = sk._window_slots(m)
  used = lnc > 0
  lens, starts = lnc[used], sk.window_grad_rows(m)[used]
  rows = (torch.repeat_interleave(starts - (torch.cumsum(lens, 0) - lens),
                                  lens)
          + torch.arange(int(lens.sum()), device=dev))
  vals = torch.randn((rows.numel(), slabw), device=dev)
  acc = torch.zeros_like(buf)
  merge_ms = cuda_ms(lambda: acc.index_add_(0, rows, vals), 5)
  b3_ms, b3_by = bound_ms(vals.numel(), nbytes(rows, vals, buf))
  log(f"  K3 (fused into K2): index_add_ of {rows.numel()} gradient rows "
      f"{merge_ms:.3f} ms, bound {b3_ms:.4f} ms ({b3_by})")
  k3 = {"launches": launches["stream_backward"], "max_abs_err": err,
        "ms": k_ms, "plain_ms": merge_ms, "bound_ms": b3_ms,
        "bound_by": b3_by, "library_ms": merge_ms,
        "resident_warps_per_sm": occ2["warps_per_sm"]}
  return k2, k3


def sorted_mapped(packed, depth, feats, image_size, config, dev):
  """The port's calibrate_mapper + map_to_tiles on the card:
  (config with the calibrated windows, mapping)."""
  from tpu_splatting_torch import map_to_tiles
  from tpu_splatting_torch.mapper.tile_mapper import calibrate_mapper
  p, d, f = (torch.from_numpy(x).to(dev) for x in (packed, depth, feats))
  t0 = time.perf_counter()
  cal = calibrate_mapper(p, d, image_size, config)
  cfg = dataclasses.replace(config, tile_window=cal["tile_window"],
                            big_capacity=cal["big_capacity"])
  m = map_to_tiles(p, d, image_size, cfg, max_overlaps=cal["max_overlaps"],
                   features=f)
  torch.cuda.synchronize()
  assert int(m.num_overflow) == 0, int(m.num_overflow)
  cnt = m.chunk_cnt
  shown = ("tile_window", "big_capacity", "max_overlaps", "num_wide")
  log(f"  calibration + mapping {time.perf_counter() - t0:.2f} s: "
      f"{ {k: cal[k] for k in shown} } "
      f"overlaps {int(cnt.sum())} chunks {m.num_chunks} (used "
      f"{int((cnt > 0).sum())}), most chunks of a tile "
      f"{int(torch.bincount(m.chunk_to_tile.long())[:m.num_tiles].max())}")
  return cfg, m


def sorted_forward_vs_twin(m, config, label, reps=3):
  """K4 against forward_reference: (image max abs error, kernel ms, twin
  ms); visibility per row <= 1e-4 * max + 1e-6."""
  from tpu_splatting_torch.rasterizer import kernels as kk
  args = (m.sorted_payload, m.chunk_src, m.chunk_cnt, m.chunk_to_tile,
          config, m.num_tiles, m.tiles_wide)
  img, vis = kk.forward(*args)
  img_t, vis_t = kk.forward_reference(*args)
  torch.cuda.synchronize()
  assert torch.isfinite(img).all() and torch.isfinite(vis).all(), label
  err = float((img - img_t).abs().max())
  vis_err = float((vis - vis_t).abs().max())
  vis_tol = 1e-4 * float(vis_t.abs().max()) + 1e-6
  k_ms = cuda_ms(lambda: kk.forward(*args), reps)
  t_ms = cuda_ms(lambda: kk.forward_reference(*args), 1)
  log(f"  {label} K4: image max_abs_err {err:.3e} (tol {TOL:g}), "
      f"visibility {vis_err:.3e} (tol {vis_tol:.3e})  kernel {k_ms:.3f} ms"
      f"  twin {t_ms:.3f} ms")
  assert err <= TOL, f"{label}: K4 disagrees with its twin ({err})"
  assert vis_err <= vis_tol, f"{label}: K4 visibility ({vis_err})"
  return err, k_ms, t_ms


def sorted_backward_vs_twin(m, config, label, reps=3):
  """K5 against backward_reference on one cotangent, column by column
  (<= 1e-4 * max |twin column| + 1e-6): (max abs error, kernel ms, twin
  ms, gradient rows)."""
  from tpu_splatting_torch.rasterizer import kernels as kk
  img, _ = kk.forward(m.sorted_payload, m.chunk_src, m.chunk_cnt,
                      m.chunk_to_tile, config, m.num_tiles, m.tiles_wide,
                      with_vis=False)
  gen = torch.Generator(device=img.device).manual_seed(5)
  gimg = torch.randn(img.shape, generator=gen, device=img.device)
  args = (m.sorted_payload, img, gimg, m.chunk_src, m.chunk_cnt,
          m.chunk_to_tile, config, m.num_tiles, m.tiles_wide)
  got = kk.backward(*args)
  again = kk.backward(*args)
  want = kk.backward_reference(*args)
  torch.cuda.synchronize()
  assert torch.isfinite(got).all(), f"{label}: non-finite K5 output"
  err_col = (got - want).abs().amax(0)
  tol_col = 1e-4 * want.abs().amax(0) + 1e-6
  err = float(err_col.max())
  rerun = float((got - again).abs().max())
  k_ms = cuda_ms(lambda: kk.backward(*args), reps)
  t_ms = cuda_ms(lambda: kk.backward_reference(*args), 1)
  log(f"  {label} K5: max_abs_err {err:.3e}, worst column at "
      f"{float((err_col / tol_col).max()):.3f} of its tolerance; two runs "
      f"differ by {rerun:.3e} at most  kernel {k_ms:.3f} ms  twin "
      f"{t_ms:.3f} ms")
  assert bool((err_col <= tol_col).all()), (
      f"{label}: K5 disagrees with its twin", err_col.tolist(),
      tol_col.tolist())
  assert bool(((got - again).abs().amax(0) <= tol_col).all()), label
  return err, k_ms, t_ms, got, rerun


def segment_sum_checks(x, by_point, n, label):
  """K7 on the per-slot rows x (A, C) through the sort's order: against
  its twin per column (<= 1e-5 * max + 1e-6), bit for bit against the
  unfused call on x[order] and on a second run.  Returns (max abs error against the twin, the fused result)."""
  from tpu_splatting_torch.rasterizer import layout
  ids, order = by_point
  got = layout.segment_sum_sorted(x, ids, n, order=order)
  want = layout.segment_sum_sorted_reference(x, ids, n, order=order)
  unfused = layout.segment_sum_sorted(x[order], ids, n)
  again = layout.segment_sum_sorted(x, ids, n, order=order)
  torch.cuda.synchronize()
  assert torch.isfinite(got).all(), f"{label}: non-finite K7 output"
  for name, other in (("the unfused call on x[order]", unfused),
                      ("a second run", again)):
    assert torch.equal(got.view(torch.int32), other.view(torch.int32)), (
        f"{label}: fused K7 differs from {name}")
  err_col = (got - want).abs().amax(0)
  tol_col = 1e-5 * want.abs().amax(0) + 1e-6
  err = float(err_col.max())
  log(f"  {label} K7 at C {x.shape[1]}: bit for bit the unfused call and "
      f"a second run; against its twin max_abs_err "
      f"{err:.3e}, worst column at {float((err_col / tol_col).max()):.3f} "
      f"of its tolerance")
  assert bool((err_col <= tol_col).all()), (
      f"{label}: K7 disagrees with its twin", err_col.tolist())
  return err, got


def row_gather_check(table, idx, label):
  """row_gather bit for bit against its twin, indices outside the table
  included (they come out 0)."""
  from tpu_splatting_torch.rasterizer import layout
  got = layout.row_gather(table, idx)
  want = layout.row_gather_reference(table, idx)
  torch.cuda.synchronize()
  assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (
      f"{label}: row_gather differs from its twin")
  log(f"  {label} row_gather ({tuple(table.shape)} table, {idx.shape[0]} "
      f"{idx.dtype} indices, {int(((idx < 0) | (idx >= table.shape[0])).sum())}"
      f" outside it): bit-exact against its twin")


def layout_vs_twins(m, gout, label):
  """K6 bit for bit on the overlap ids and the sorted rows; K7 on the
  gradient rows through the point-id order at C 12 (the float4 path), at
  C 1 and at C 21 (the scalar paths), as segment_sum_checks; row_gather
  on those rows.  Returns K7's largest max abs error."""
  from tpu_splatting_torch.rasterizer import function as fn
  from tpu_splatting_torch.rasterizer import layout
  g = m.chunk_size
  for rows in (m.overlap_to_point, m.sorted_payload):
    got = layout.window_copy(rows, m.chunk_src, m.chunk_cnt, g)
    want = layout.window_copy_reference(rows, m.chunk_src, m.chunk_cnt, g)
    assert torch.equal(got, want), f"{label}: K6 differs from its twin"
  by_point = fn.sort_point_ids(fn._pid_chunked(m))
  wide = torch.cat([gout, gout[:, :9]], 1)
  err = max(segment_sum_checks(x, by_point, m.num_points, label)[0]
            for x in (gout, gout[:, :1].contiguous(), wide))
  idx = by_point.order.clone()
  idx[::97] = -1
  idx[1::97] = gout.shape[0]
  row_gather_check(gout, idx, label)
  row_gather_check(wide, idx.to(torch.int32), label)
  return err


def phase_sorted_twin(dev):
  """Phase 5: (K4, K5, K7 max errors) at the check shapes."""
  from tpu_splatting_torch import RasterConfig
  from tpu_splatting_torch.rasterizer import kernels as kk
  from tpu_splatting_torch.scenes import heavy_scene, uniform_scene
  e4, e5, e7 = [], [], []
  # heavy splats reach ~100 px sigma: a big-path window as wide as the
  # image (64 tiles) leaves no span clipped; chunks of 32 rows give its
  # clustered tiles many chunks (the carries across chunks)
  for name, gen, seed, big_window, g in (
      ("uniform", uniform_scene, 0, 16, 128),
      ("heavy", heavy_scene, 1, 64, 32)):
    log(f"phase 5: K4-K7 vs twins, {name} {N_SMALL} splats {SIZE_SMALL}, "
        f"pipeline sorted, big_tile_window {big_window}, chunk_size {g}")
    packed, depth, feats = gen(np.random.default_rng(seed), N_SMALL,
                               SIZE_SMALL)
    base = RasterConfig(pipeline="sorted", big_tile_window=big_window,
                        chunk_size=g)
    cfg, m = sorted_mapped(packed, depth, feats, SIZE_SMALL, base, dev)
    reps = 3 if name == "uniform" else 1
    e4.append(sorted_forward_vs_twin(m, cfg, f"{name} blending", reps)[0])
    if name == "heavy":
      walked_share(sorted_walk_mask(
          m.sorted_payload, m.chunk_src, m.chunk_cnt, m.chunk_to_tile, cfg,
          m.num_tiles, m.tiles_wide), "heavy K4")
    e4.append(sorted_forward_vs_twin(
        m, dataclasses.replace(cfg, antialias=True), f"{name} antialias",
        reps)[0])
    _, mq = sorted_mapped(packed, depth, depth[:, None], SIZE_SMALL, cfg,
                          dev)
    e4.append(sorted_forward_vs_twin(
        mq, dataclasses.replace(cfg, use_alpha_blending=False,
                                saturate_threshold=0.25), f"{name} quantile",
        reps)[0])
    e5.append(sorted_backward_vs_twin(m, cfg, f"{name} blending", reps)[0])
    e5.append(sorted_backward_vs_twin(
        m, dataclasses.replace(cfg, antialias=True), f"{name} antialias",
        reps)[0])
    err, _, _, gout, _ = sorted_backward_vs_twin(
        m, dataclasses.replace(cfg, **HEUR), f"{name} heuristics", reps)
    e5.append(err)
    e7.append(layout_vs_twins(m, gout, name))

  # past the headline: 64 features (the generic instantiations) and
  # 16-pixel tiles (half a warp: padded with frozen lanes)
  packed, depth, feats = uniform_scene(np.random.default_rng(0), N_SMALL,
                                       SIZE_SMALL)
  wide = wide_features(N_SMALL, 64)
  for num_f, ts in ((64, 16), (3, 4), (64, 4)):
    log(f"phase 5: K4 and K5 vs twins, uniform {N_SMALL} splats "
        f"{SIZE_SMALL}, {num_f} features, tile_size {ts}")
    base = RasterConfig(pipeline="sorted", tile_size=ts)
    cfg, m = sorted_mapped(packed, depth, wide if num_f == 64 else feats,
                           SIZE_SMALL, base, dev)
    e4.append(sorted_forward_vs_twin(m, cfg, f"F {num_f} tile {ts} blending",
                                     1)[0])
    for label, extra in (("blending", {}), ("antialias", dict(antialias=True)),
                         ("heuristics", HEUR)):
      e5.append(sorted_backward_vs_twin(
          m, dataclasses.replace(cfg, **extra),
          f"F {num_f} tile {ts} {label}", 1)[0])
  return max(e4), max(e5), max(e7)


def sorted_cross_device_check(dev):
  """A small 3D scene's projected splats mapped by map_to_tiles on the
  card and on the CPU (every integer field identical, the payload equal),
  and one sorted render_with_heuristics step on each device (equal loss
  to 1e-4 relative)."""
  from tpu_splatting_torch import (RasterConfig, map_to_tiles,
                                   render_with_heuristics)
  from tpu_splatting_torch.convert import TILE_MAPPING_INT_FIELDS
  from tpu_splatting_torch.perspective.projection import (ndc_depth,
                                                          project_to_image)
  from tpu_splatting_torch.scenes import lift_to_3d, uniform_scene
  from tpu_splatting_torch.spherical_harmonics import evaluate_sh_at
  size = (256, 192)
  packed, depth, feats = uniform_scene(np.random.default_rng(2), 20_000,
                                       size)
  cfg = RasterConfig(pipeline="sorted", **HEUR)
  cap = 200_000
  g3d, cam = lift_to_3d(packed, depth, feats, size, near=0.1, far=100.0,
                        fov_deg=70.0, device=dev)
  with torch.no_grad():
    g2d, depths, _ = project_to_image(g3d, cam, cfg)
    sh = evaluate_sh_at(g3d.feature, g3d.position, cam.camera_position)
    nd = torch.where(depths > 0,
                     ndc_depth(depths, cam.near_plane, cam.far_plane), 0.0)
    maps = [map_to_tiles(g2d.to(d), nd.to(d), size, cfg, max_overlaps=cap,
                         features=sh.to(d)) for d in (dev, "cpu")]
  assert int(maps[1].num_overflow) == 0
  for name in TILE_MAPPING_INT_FIELDS:
    a, b = getattr(maps[0], name).cpu(), getattr(maps[1], name)
    assert torch.equal(a, b), f"sorted mapper differs on card and CPU: {name}"
  assert torch.equal(maps[0].sorted_payload.cpu(), maps[1].sorted_payload)
  tgt = torch.from_numpy(np.random.default_rng(7).random(
      (size[1], size[0], 3)).astype(np.float32))
  losses = []
  for d in (dev, "cpu"):
    t = tgt.to(d)
    g_d = g3d.replace(**{f.name: getattr(g3d, f.name).to(d)
                         for f in dataclasses.fields(g3d)})
    loss, r, grads = render_with_heuristics(
        lambda r, t=t: ((r.image - t) ** 2).sum(), g_d, cam.to(d), cfg,
        use_sh=True, max_overlaps=cap)
    assert int(r.num_overflow) == 0
    assert torch.isfinite(grads.position).all(), d
    losses.append(float(loss))
  log(f"  small sorted scene {size}: mapper identical on card and CPU "
      f"({int(maps[1].chunk_cnt.sum())} overlaps); training step loss card "
      f"{losses[0]:.6f} CPU {losses[1]:.6f}")
  assert abs(losses[0] - losses[1]) <= 1e-4 * abs(losses[1]), losses


def sorted_caps(g3d, cams):
  """(config, max_overlaps) of the sorted pipeline at the headline: the
  port's calibrate_mapper, max over the poses."""
  from tpu_splatting_torch import RasterConfig
  from tpu_splatting_torch.mapper.tile_mapper import calibrate_mapper
  from tpu_splatting_torch.perspective.projection import (ndc_depth,
                                                          project_to_image)
  base = RasterConfig(pipeline="sorted")
  t0 = time.perf_counter()
  caps = {}
  with torch.no_grad():
    for cam in cams:
      g2d, depths, _ = project_to_image(g3d, cam, base)
      nd = torch.where(depths > 0,
                       ndc_depth(depths, cam.near_plane, cam.far_plane), 0.0)
      cal = calibrate_mapper(g2d, nd, SIZE_FULL, base)
      for k in ("tile_window", "big_capacity", "max_overlaps"):
        caps[k] = max(caps.get(k, 0), cal[k])
      del g2d, depths, nd
  torch.cuda.synchronize()
  log(f"  calibration (5 poses): {time.perf_counter() - t0:.2f} s; caps "
      f"(max over poses) {caps}; identity-pose hits upper bound "
      f"{cal['measured_hits_upper_bound']}, wide {cal['num_wide']}")
  cfg = dataclasses.replace(base, tile_window=caps["tile_window"],
                            big_capacity=caps["big_capacity"])
  return cfg, caps["max_overlaps"]


def short_kernel_name(name):
  """A CUDA kernel's name from the profiler, without its return type,
  namespaces, template arguments and parameters."""
  name = name.replace("(anonymous namespace)::", "")
  name = name.split("(")[0].split("<")[0]
  return name.split()[-1].split("::")[-1]


def reduce_split(m, by_point, xs, n):
  """The parts of the sorted reduce as the path runs them, each timed
  alone, as a call (CUDA events over 5 calls) and by device time
  (torch.profiler over 20 calls, with the kernels it ran by name): the
  point ids (K6 + where) and their stable sort, once a step, then K7
  reading each of the per-slot rows xs (A, C) through the order.
  Returns {part: (call ms, {kernel: device ms})}."""
  from tpu_splatting_torch.rasterizer import function as fn
  from tpu_splatting_torch.rasterizer import layout
  pid = fn._pid_chunked(m)
  ids, order = by_point
  parts = [("point ids (K6 + where)", lambda: fn._pid_chunked(m), None),
           ("stable sort", lambda: torch.sort(pid, stable=True), None)]
  parts += [(f"K7 through the order, C {x.shape[1]}",
             lambda x=x: layout.segment_sum_sorted(x, ids, n, order=order), 2)
            for x in xs]
  out = {}
  for name, f, kernels in parts:
    call = cuda_ms(f, 5)
    split = device_split(f, kernels=kernels)
    out[name] = (call, split)
    log(f"    {name}: a call {call:.4f} ms, device "
        f"{sum(split.values()):.4f} ms [" + "; ".join(
            f"{short_kernel_name(k)} {v:.4f}"
            for k, v in sorted(split.items(), key=lambda kv: -kv[1])) + "]")
  return out


def phase_sorted_full(dev, g3d, cams, stream_cfg):
  """Phase 6: the sorted pipeline at full size.  Returns the K4-K7
  entries of the kernels line (without the phase-5 errors)."""
  from tpu_splatting_torch import (map_to_tiles, render_gaussians,
                                   render_with_heuristics)
  from tpu_splatting_torch.mapper.tile_mapper import tile_shape
  from tpu_splatting_torch.optim import GroupConfig, VisibilityAwareAdam
  from tpu_splatting_torch.perspective.projection import (ndc_depth,
                                                          project_to_image)
  from tpu_splatting_torch.rasterizer import function as fn
  from tpu_splatting_torch.rasterizer import kernels as kk
  from tpu_splatting_torch.rasterizer import layout
  from tpu_splatting_torch.rasterizer.stream_function import detile
  from tpu_splatting_torch.spherical_harmonics import evaluate_sh_at

  log(f"phase 6: sorted pipeline, {N_FULL} splats {SIZE_FULL} SH degree 3")
  cfg, cap = sorted_caps(g3d, cams)

  def counts():
    return {**kk.launch_counts, **kk.probe_launch_counts,
            **layout.launch_counts, **layout.probe_launch_counts,
            "point_id_sorts": fn.sort_counts["point_ids"]}

  # three requests through the public entry point
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  kk.reset_launch_counts()
  layout.reset_launch_counts()
  fn.sort_counts["point_ids"] = 0
  times = []
  with torch.no_grad():
    for i, cam in enumerate(cams[:3]):
      median = i == 2
      t0 = time.perf_counter()
      r = render_gaussians(g3d, cam, cfg, use_sh=True, max_overlaps=cap,
                           render_median_depth=median)
      torch.cuda.synchronize()
      times.append((time.perf_counter() - t0) * 1e3)
      assert int(r.num_overflow) == 0, (i, int(r.num_overflow))
      assert torch.isfinite(r.image).all(), i
      w_min, w_max = float(r.image_weight.min()), float(r.image_weight.max())
      assert w_min >= 0.0 and w_max <= 1.0 + 1e-6, (i, w_min, w_max)
      if median:
        assert torch.isfinite(r.median_depth_image).all()
      if i == 0:
        image0 = r.image
      log(f"  request {i}: {times[-1]:.2f} ms  weight in [{w_min:.4f}, "
          f"{w_max:.6f}]  mean rgb {r.image.mean().item():.4f}"
          + ("  (+median pass)" if median else ""))
  render_launches = counts()
  render_peak = torch.cuda.max_memory_allocated() / 2 ** 30
  log(f"  launches in the 3 requests: {render_launches}")
  assert render_launches["sorted_forward"] >= 3, render_launches
  log(f"  end-to-end ms per render: {[round(t, 3) for t in times]}")
  log(f"  peak device memory: {render_peak:.3f} GiB")

  with torch.no_grad():
    r_stream = render_gaussians(g3d, cams[0], stream_cfg, use_sh=True)
    diff = (image0 - r_stream.image).abs()
  log(f"  sorted vs stream image, pose 0 (information only): max abs "
      f"{float(diff.max()):.4e}, mean abs {float(diff.mean()):.4e}")
  del r_stream, diff

  # three training steps
  tcfg = dataclasses.replace(cfg, **HEUR)
  tgt = torch.from_numpy(np.random.default_rng(7).random(
      (SIZE_FULL[1], SIZE_FULL[0], 3)).astype(np.float32)).to(dev)

  def loss_fn(rendering):
    err = rendering.image - tgt
    return (err * err).sum()

  opt = VisibilityAwareAdam({"feature": GroupConfig(lr=1e-3)})
  state = opt.init({"feature": g3d.feature})
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  before = counts()
  step_times = []
  for i, cam in enumerate(cams[:3]):
    t0 = time.perf_counter()
    loss, r, grads = render_with_heuristics(loss_fn, g3d, cam, tcfg,
                                            use_sh=True, max_overlaps=cap)
    vis = r.points.visibility
    params, state = opt.step({"feature": g3d.feature},
                             {"feature": grads.feature}, state, vis)
    g3d = g3d.replace(feature=params["feature"])
    torch.cuda.synchronize()
    step_times.append((time.perf_counter() - t0) * 1e3)
    assert int(r.num_overflow) == 0, (i, int(r.num_overflow))
    assert np.isfinite(float(loss)), i
    for name in ("position", "log_scaling", "rotation", "alpha_logit",
                 "feature"):
      assert torch.isfinite(getattr(grads, name)).all(), (i, name)
    for name in ("prune_cost", "split_score"):
      assert torch.isfinite(getattr(r.points, name)).all(), (i, name)
    assert float(vis.min()) >= 0.0, (i, float(vis.min()))
    log(f"  step {i}: {step_times[-1]:.2f} ms  loss {float(loss):.4f}  "
        f"visible {int((vis > 0).sum())}")
  after = counts()
  step_launches = {k: after[k] - before[k] for k in after}
  step_peak = torch.cuda.max_memory_allocated() / 2 ** 30
  log(f"  launches in the 3 steps: {step_launches}")
  for k in ("sorted_forward", "sorted_backward", "window_copy",
            "segment_sum_sorted"):
    assert step_launches[k] >= 3, (k, step_launches)
  # the visibility reduce and the backward share one sort of the point ids
  assert step_launches["point_id_sorts"] == 3, step_launches
  log(f"  end-to-end ms per training step: "
      f"{[round(t, 3) for t in step_times]}")
  log(f"  peak device memory: {step_peak:.3f} GiB")
  launches = after

  # staged timing of one render and one step (CUDA events)
  cam = cams[0]
  n = g3d.position.shape[0]
  ts = cfg.tile_size
  tw, th = tile_shape(SIZE_FULL, ts)
  t_all = tw * th
  runs = []
  with torch.no_grad():
    for sync in (False, False, True):  # warm once, events, each alone
      st = Stages(sync)
      st.mark()
      g2d, depths, _ = project_to_image(g3d, cam, cfg)
      st.mark()
      feats = evaluate_sh_at(g3d.feature, g3d.position, cam.camera_position)
      st.mark()
      nd = torch.where(depths > 0,
                       ndc_depth(depths, cam.near_plane, cam.far_plane), 0.0)
      m = map_to_tiles(g2d, nd, SIZE_FULL, cfg, max_overlaps=cap,
                       features=feats)
      st.mark()
      it, _ = kk.forward(m.sorted_payload, m.chunk_src, m.chunk_cnt,
                         m.chunk_to_tile, cfg, t_all, tw, with_vis=False)
      st.mark()
      detile(it[:t_all], tw, th, ts, SIZE_FULL)
      st.mark()
      runs.append(st)
  names = ("project", "SH", "map", "K4", "detile")
  runs[1].log("render stages", names)
  runs[2].log("render stages, each alone", names)
  log(f"  full mapping: {int(m.chunk_cnt.sum())} overlaps in "
      f"{m.num_chunks} chunks of {m.chunk_size}")

  names = ("forward to map", "K4 + visibility", "visibility reduce",
           "loss gradient", "K5", "backward reduce", "autograd tail",
           "optimizer")
  runs = []
  for sync in (False, False, True):    # warm once, events, each alone
    st = Stages(sync)
    st.mark()
    leaves = [getattr(g3d, f.name).detach().requires_grad_(True)
              for f in dataclasses.fields(g3d)]
    g = g3d.replace(**{f.name: x for f, x in
                       zip(dataclasses.fields(g3d), leaves)})
    g2d, depths, _ = project_to_image(g, cam, tcfg)
    feats = evaluate_sh_at(g.feature, g.position.detach(),
                           cam.camera_position)
    nd = torch.where(depths > 0,
                     ndc_depth(depths, cam.near_plane, cam.far_plane), 0.0)
    m = map_to_tiles(g2d.detach(), nd.detach(), SIZE_FULL, tcfg,
                     max_overlaps=cap, features=feats.detach())
    st.mark()
    it, vis_c = kk.forward(m.sorted_payload, m.chunk_src, m.chunk_cnt,
                           m.chunk_to_tile, tcfg, t_all, tw, with_vis=True)
    st.mark()
    by_point = fn.sort_point_ids(fn._pid_chunked(m))
    vis = fn.reduce_chunked_to_points(vis_c, by_point, n)[:, 0]
    st.mark()
    it_g = it.detach().requires_grad_(True)
    full = detile(it_g[:t_all], tw, th, ts, SIZE_FULL)
    (g_it,) = torch.autograd.grad(((full[..., :3] - tgt) ** 2).sum(), it_g)
    st.mark()
    gout = kk.backward(m.sorted_payload, it, g_it, m.chunk_src, m.chunk_cnt,
                       m.chunk_to_tile, tcfg, t_all, tw)
    st.mark()
    red = fn.reduce_chunked_to_points(gout, by_point, n)
    st.mark()
    tail = torch.autograd.grad([g2d, feats], leaves,
                               [red[:, :7], red[:, 7:10]])
    st.mark()
    opt.step({"feature": g3d.feature}, {"feature": tail[4]}, state, vis)
    st.mark()
    runs.append(st)
  runs[1].log("step stages", names)
  runs[2].log("step stages, each alone", names)

  # K4-K7 at the full-size shapes: kernel, twin, bound, library call
  log("  K4-K7 vs twins at the full-size shapes")
  err4, k4_ms, t4_ms = sorted_forward_vs_twin(m, tcfg, "full blending",
                                              reps=5)
  walked_share(sorted_walk_mask(
      m.sorted_payload, m.chunk_src, m.chunk_cnt, m.chunk_to_tile, tcfg,
      m.num_tiles, m.tiles_wide), "K4")
  err5, k5_ms, t5_ms, gout, rerun5 = sorted_backward_vs_twin(
      m, tcfg, "full heuristics", reps=5)
  err7 = layout_vs_twins(m, gout, "full")
  f = m.feature_size
  valid = int(m.chunk_cnt.sum())
  pairs = valid * tcfg.tile_area
  out_w = gout.shape[1]
  g = m.chunk_size
  row_bytes = valid * (7 + f) * 4
  idx_bytes = nbytes(m.chunk_src, m.chunk_cnt, m.chunk_to_tile)
  b4 = bound_ms(pairs * K4_OPS_PER_PAIR,
                row_bytes + idx_bytes + nbytes(it, vis_c))
  b5 = bound_ms(pairs * k2_ops_per_pair(out_w),
                row_bytes + idx_bytes + 2 * nbytes(it) + nbytes(gout))
  log(f"  K4 bound {b4[0]:.4f} ms ({b4[1]}), K5 bound {b5[0]:.4f} ms "
      f"({b5[1]}): {pairs} (row, pixel) pairs")
  floor4 = floor_vs_plain(
      "forward_floor", kk.forward_floor, kk.forward_floor_reference,
      (m.sorted_payload, m.chunk_src, m.chunk_cnt, m.chunk_to_tile, tcfg,
       m.num_tiles, m.tiles_wide), row_bytes + idx_bytes, "full")
  log(f"  K4 {k4_ms:.3f} ms = floor (staging) {floor4['ms']:.3f} + walk "
      f"{k4_ms - floor4['ms']:.3f} ms")
  plans = kernel_plans(f, tcfg.tile_area, 512, 27, g)
  occ4 = occupancy_of("K4", plans["K4"][2])
  occ5 = occupancy_of("K5", plans["K5"][2])
  log(f"  K4 {occ4}, K5 {occ5} at the full shapes")

  # K6 and K7 take tens of microseconds: each is timed twice, as calls
  # (events over back-to-back calls, the wrapper's host work included
  # where the device waits for it) and by device time (device_ms)
  o2p, src, cnt = m.overlap_to_point, m.chunk_src, m.chunk_cnt
  k6_ms = cuda_ms(lambda: layout.window_copy(o2p, src, cnt, g), 5)
  k6_dev = device_ms(lambda: layout.window_copy(o2p, src, cnt, g),
                     kernels=1)
  t6_ms = cuda_ms(lambda: layout.window_copy_reference(o2p, src, cnt, g), 5)
  r = torch.arange(g, device=dev)
  flat = torch.where(r < cnt[:, None], src.long()[:, None] + r,
                     o2p.shape[0]).reshape(-1)
  o2p_ext = torch.cat([o2p, o2p.new_zeros(1)])
  assert torch.equal(o2p_ext[flat], layout.window_copy(o2p, src, cnt, g))
  l6_ms = cuda_ms(lambda: o2p_ext[flat], 5)
  l6_dev = device_ms(lambda: o2p_ext[flat])
  b6 = bound_ms(0, nbytes(src, cnt) + valid * 4 + flat.numel() * 4)
  log(f"  K6 (overlap ids, {flat.numel()} slots): kernel {k6_ms:.4f} ms a "
      f"call, {k6_dev:.4f} ms of device time; torch indexing "
      f"{l6_ms:.4f} ms a call, {l6_dev:.4f} ms of device time; twin "
      f"{t6_ms:.3f} ms; bound {b6[0]:.4f} ms ({b6[1]}), device time at "
      f"{b6[0] / k6_dev:.1%} of it")

  # K7 as the path calls it: the gradient rows read through the point-id
  # order inside the kernel (its bounds pass included)
  by_point = fn.sort_point_ids(fn._pid_chunked(m))
  ids, order = by_point
  err7 = max(err7, segment_sum_checks(vis_c, by_point, n,
                                      "full visibility")[0])
  torch.cuda.synchronize()
  held = torch.cuda.memory_allocated()
  torch.cuda.reset_peak_memory_stats()
  searchsorted = torch.searchsorted

  def refuse(*args, **kw):
    raise AssertionError("the reduce called torch.searchsorted")
  torch.searchsorted = refuse
  try:
    fn.reduce_chunked_to_points(gout, by_point, n)
  finally:
    torch.searchsorted = searchsorted
  torch.cuda.synchronize()
  grew = torch.cuda.max_memory_allocated() - held
  log(f"  the backward reduce calls no searchsorted and allocates {grew} B "
      f"at most (the per-slot rows are {nbytes(gout)} B: no sorted copy)")
  assert grew < nbytes(gout) // 2, grew

  log("  the reduce's parts, each alone:")
  split = reduce_split(m, by_point, (gout, vis_c), n)
  k7_ms, k7_parts = split[f"K7 through the order, C {out_w}"]
  k7_dev = sum(k7_parts.values())
  t7_ms = cuda_ms(lambda: layout.segment_sum_sorted_reference(
      gout, ids, n, order=order), 5)
  # one PyTorch call on the same rows: index_add_ by the unsorted ids
  pid = fn._pid_chunked(m).long()
  acc = torch.zeros((n + 1, out_w), device=dev)
  l7_ms = cuda_ms(lambda: acc.index_add_(0, pid, gout), 5)
  l7_dev = device_ms(lambda: acc.index_add_(0, pid, gout))
  # bytes it must move: each valid row (id < n) with its id and order
  # entry, and the output (the bounds are the kernel's scratch); printed
  # beside the count of every slot (padding included) and the bounds that
  # the bound took before K7 read its order
  nb7 = valid * (out_w * 4 + 4 + order.element_size()) + n * out_w * 4
  nb7_slots = nbytes(gout, ids) + (n + 1) * 4 + n * out_w * 4
  b7 = bound_ms(0, nb7)
  log(f"  K7 ({gout.shape[0]} slots, {valid} valid, x {out_w} columns -> "
      f"{n} points, int64 order read in the kernel): {k7_ms:.4f} ms a call,"
      f" {k7_dev:.4f} ms of device time [" + "; ".join(
          f"{short_kernel_name(k)} {v:.4f}" for k, v in k7_parts.items())
      + f"]; index_add_ by the unsorted ids {l7_ms:.4f} ms a call, "
      f"{l7_dev:.4f} ms of device time; twin {t7_ms:.3f} ms")
  log(f"  K7 bound: {nb7} B (valid rows, ids, order, output) -> "
      f"{b7[0]:.4f} ms, device time at {b7[0] / k7_dev:.1%} of it; every "
      f"slot and the bounds counted: {nb7_slots} B -> "
      f"{bound_ms(0, nb7_slots)[0]:.4f} ms")

  # the row-gather probe: at the reduce's shape (the gradient rows through
  # the valid part of the order) and at benchmarks/exp_gather.py's defaults
  rg = {}
  rng = np.random.default_rng(0)
  table0 = torch.from_numpy(rng.random((1_000_000, 16)).astype(
      np.float32)).to(dev)
  idx0 = torch.from_numpy(rng.integers(0, 1_000_000, 4_194_304).astype(
      np.int32)).to(dev)
  for shape, table, idx in (("reduce", gout, order[:valid]),
                            ("probe defaults", table0, idx0)):
    row_gather_check(table, idx, f"full {shape}")
    ms = cuda_ms(lambda: layout.row_gather(table, idx), 5)
    dev_ms = device_ms(lambda: layout.row_gather(table, idx), kernels=1)
    p_ms = cuda_ms(lambda: layout.row_gather_reference(table, idx), 5)
    lib_ms = cuda_ms(lambda: table[idx], 5)
    lib_dev = device_ms(lambda: table[idx])
    # the table rows this run's indices need, each read once, the indices
    # read and the output written
    inside = idx[(idx >= 0) & (idx < table.shape[0])]
    need = int(torch.unique(inside).numel())
    b = bound_ms(0, (need + idx.shape[0]) * table.shape[1]
                 * table.element_size() + nbytes(idx))
    log(f"  row_gather at the {shape} ({tuple(table.shape)} table, "
        f"{idx.shape[0]} {idx.dtype} indices, {need} rows needed): "
        f"{ms:.4f} ms a call, "
        f"{dev_ms:.4f} ms of device time; torch indexing {lib_ms:.4f} ms a "
        f"call, {lib_dev:.4f} ms of device time; plain {p_ms:.3f} ms; bound "
        f"{b[0]:.4f} ms ({b[1]}), device time at {b[0] / dev_ms:.1%} of it")
    rg[shape] = (ms, dev_ms, p_ms, lib_ms, lib_dev, b)
  del table0, idx0
  log(f"  fused K7 {k7_dev:.4f} ms - row_gather at the reduce's shape "
      f"{rg['reduce'][1]:.4f} ms = {k7_dev - rg['reduce'][1]:.4f} ms of "
      f"device time: the segment sum on top of its gather")

  def entry(name, src_file, line, count, err, ms, plain, b, lib, **extra):
    return dict(name=name, route="cuda",
                source="tpu_splatting_torch/csrc/" + src_file,
                replaces=line, launches=count, max_abs_err=err, ms=ms,
                plain_ms=plain, bound_ms=b[0], bound_by=b[1],
                library_ms=lib, **extra)
  ref = "tpu_splatting/rasterizer/"
  return [
      entry("sorted_forward", "sorted_forward.cu", ref + "kernels.py:216",
            launches["sorted_forward"], err4, k4_ms, t4_ms, b4, None,
            resident_warps_per_sm=occ4["warps_per_sm"]),
      entry("sorted_backward", "sorted_backward.cu", ref + "kernels.py:393",
            launches["sorted_backward"], err5, k5_ms, t5_ms, b5, None,
            resident_warps_per_sm=occ5["warps_per_sm"],
            run_to_run_max_abs=rerun5),
      entry("window_copy", "layout.cu", ref + "layout.py:56",
            launches["window_copy"], 0.0, k6_ms, t6_ms, b6, l6_ms,
            device_ms=k6_dev, library_device_ms=l6_dev,
            resident_warps_per_sm=occupancy_of("K6")["warps_per_sm"]),
      entry("segment_sum_sorted", "layout.cu", ref + "layout.py:105",
            launches["segment_sum_sorted"], err7, k7_ms, t7_ms, b7, l7_ms,
            device_ms=k7_dev, library_device_ms=l7_dev,
            resident_warps_per_sm=occupancy_of("K7")["warps_per_sm"]),
      dict(entry("row_gather", "layout.cu", "benchmarks/exp_gather.py:92",
                 launches["row_gather"], 0.0, rg["reduce"][0],
                 rg["reduce"][2], rg["reduce"][5], rg["reduce"][3],
                 device_ms=rg["reduce"][1],
                 library_device_ms=rg["reduce"][4],
                 probe_defaults_device_ms=rg["probe defaults"][1],
                 probe_defaults_library_device_ms=rg["probe defaults"][4],
                 probe_defaults_bound_ms=rg["probe defaults"][5][0],
                 resident_warps_per_sm=occupancy_of("row_gather")[
                     "warps_per_sm"]),
           main_path=False, probe_of="segment_sum_sorted",
           also_replaces=["benchmarks/exp_gather.py:34",
                          "benchmarks/exp_gather.py:54"]),
      dict(name="forward_floor", route="cuda",
           source="tpu_splatting_torch/csrc/sorted_forward.cu",
           replaces="benchmarks/exp_kernel_floor.py:29",
           launches=launches["sorted_forward_floor"], **floor4),
  ]


N_SHARDS = 4        # virtual shards of one card in phase 7


def shard_kernels_vs_twins(m, cfg, label, mesh):
  """Phase 7's kernel checks on one mapping split into band shards: K1
  with band0 against its twin (TOL) and bit for bit the unsharded image's
  bands, K2 in halo mode against its twin per column (heuristics), the
  halo merge bit for bit its plain twin on K2's buffers.  Returns (K1
  error, K2 error)."""
  from tpu_splatting_torch.parallel import stream_sharded as ss
  from tpu_splatting_torch.rasterizer import stream_kernels as sk
  hcfg = dataclasses.replace(cfg, **HEUR)
  th_local, shards = ss._shards(m, mesh)
  t_local = m.tiles_wide * th_local
  band_rows = m.tiles_wide * m.run_cap
  full = sk.stream_forward(m, cfg)
  gen = torch.Generator(device=full.device).manual_seed(7)
  gimg = torch.randn(full.shape, generator=gen, device=full.device)
  err1 = err2 = share = 0.0
  bufs = []
  for d, band0, _, lm in shards:
    rows = slice(d * t_local, (d + 1) * t_local)
    img = sk.stream_forward(lm, cfg, band0)
    want = sk.stream_forward_reference(lm, cfg, band0)
    torch.cuda.synchronize()
    err1 = max(err1, float((img - want).abs().max()))
    assert torch.equal(img, full[rows]), f"{label} shard {d}: K1 band0"
    got = sk.stream_backward(lm, img, gimg[rows], hcfg, band0, halo=True)
    want = sk.stream_backward_reference(lm, img, gimg[rows], hcfg, band0,
                                        halo=True)
    tol_col = 1e-4 * want.abs().amax(0) + 1e-6
    err_col = (got - want).abs().amax(0)
    assert bool((err_col <= tol_col).all()), (
        f"{label} shard {d}: K2 halo mode disagrees with its twin",
        err_col.tolist(), tol_col.tolist())
    assert not bool(got[-1].any())
    err2 = max(err2, float(err_col.max()))
    share = max(share, float((err_col / tol_col).max()))
    bufs.append(got)
  assert err1 <= TOL, (label, err1)
  assert not bool(bufs[0][:band_rows].any()), "rows above the image"
  assert not bool(bufs[-1][(th_local + 1) * band_rows:].any()), (
      "rows below the image")
  for d in range(len(bufs)):
    above = (bufs[d - 1][(th_local + 1) * band_rows:-1]
             if d > 0 else None)
    below = bufs[d + 1][:band_rows] if d < len(bufs) - 1 else None
    got = sk.halo_merge(bufs[d].clone(), th_local, band_rows, above, below)
    want = sk.halo_merge_reference(bufs[d].clone(), th_local, band_rows,
                                   above, below)
    assert torch.equal(got, want), f"{label} shard {d}: halo merge"
  log(f"  {label}, {len(shards)} shards of {th_local} bands: K1 band0 "
      f"max_abs_err {err1:.3e} (tol {TOL:g}), bit for bit the unsharded "
      f"bands; K2 halo mode max_abs_err {err2:.3e}, worst column at "
      f"{share:.3f} of its tolerance; halo merge bit for bit its twin")
  return err1, err2


def phase_sharded(dev, g3d, cams, cfg_caps, shard_checks, phase2_out):
  """Phase 7: the band-sharded stream path and camera-batch data
  parallelism on virtual shards of one card.  Returns (kernels-line
  entry of the halo merge, K1 and K2 additions)."""
  from tpu_splatting_torch.parallel.data_parallel import (
      data_parallel_loss, make_train_step)
  from tpu_splatting_torch.parallel.dryrun import dryrun_multichip
  from tpu_splatting_torch.parallel.mesh import all_gather, make_mesh, ppermute
  from tpu_splatting_torch.parallel import stream_sharded as ss
  from tpu_splatting_torch.optim import GroupConfig
  from tpu_splatting_torch.perspective.projection import (ndc_depth,
                                                          project_to_image)
  from tpu_splatting_torch.rasterizer import stream_kernels as sk
  from tpu_splatting_torch.rasterizer.stream_function import (
      backward_reduce, reduce_stage2, stream_map_with_config)
  from tpu_splatting_torch.renderer import render_gaussians
  from tpu_splatting_torch.spherical_harmonics import evaluate_sh_at
  t_phase = time.perf_counter()
  mesh = make_mesh(N_SHARDS, devices=[dev] * N_SHARDS)
  log(f"phase 7: band sharding and data parallelism on {N_SHARDS} virtual "
      f"shards of {dev}")

  # 7.1 the kernels against their twins at phase 2's 200k shapes
  err1 = err2 = 0.0
  for label, m, cfg in shard_checks:
    e1, e2 = shard_kernels_vs_twins(mapping_to(m, dev), cfg, label, mesh)
    err1, err2 = max(err1, e1), max(err2, e2)
  label, m, cfg = shard_checks[0]
  m = mapping_to(m, dev)
  img, gimg, buf2 = (x.to(dev) for x in phase2_out)
  img0 = sk.stream_forward(m, cfg, 0)
  hcfg = dataclasses.replace(cfg, **HEUR)
  buf0 = sk.stream_backward(m, img0, gimg, hcfg, 0, halo=False)
  again = sk.stream_backward(m, img0, gimg, hcfg)
  torch.cuda.synchronize()
  assert torch.equal(img0, img), "K1 at band0 0 differs from phase 2's"
  tol_col = 1e-4 * buf2.abs().amax(0) + 1e-6
  assert bool(((buf0 - buf2).abs().amax(0) <= tol_col).all())
  log(f"  band0 0: K1 bit for bit phase 2's image; K2 within "
      f"{float((buf0 - buf2).abs().max()):.3e} of phase 2's buffer (two "
      f"unsharded K2 runs on the same inputs differ by "
      f"{float((again - buf2).abs().max()):.3e}: its atomics)")
  del img0, buf0, again, phase2_out

  # 7.2 the headline band-sharded: identity pose, phase 4's capacities
  cfg = dataclasses.replace(cfg_caps, **HEUR)
  cam = cams[0]
  with torch.no_grad():
    g2d, depths, _ = project_to_image(g3d, cam, cfg)
    feats = evaluate_sh_at(g3d.feature, g3d.position, cam.camera_position)
    nd = torch.where(depths > 0,
                     ndc_depth(depths, cam.near_plane, cam.far_plane), 0.0)
    m = stream_map_with_config(g2d, nd, feats, SIZE_FULL, cfg)
  del g2d, depths, feats, nd
  assert int(m.num_overflow) == 0, m.overflow.tolist()
  th_local = m.tiles_high // N_SHARDS
  log(f"  headline: {m.tiles_high} bands, {N_SHARDS} shards of {th_local}; "
      f"run_cap {m.run_cap}, slab_cap {m.slab_cap}, w_max {m.w_max}")
  full = sk.stream_forward(m, cfg)
  gen = torch.Generator(device=dev).manual_seed(8)
  g_it = torch.randn(full.shape, generator=gen, device=dev)
  want = backward_reduce(m, full, g_it, cfg)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  base_mem = torch.cuda.memory_allocated()
  sk.reset_launch_counts()
  t0 = time.perf_counter()
  img_fwd = ss.band_sharded_forward(m, cfg, mesh)
  img_sh, got = ss.band_sharded_grad(m, g_it, cfg, mesh)
  torch.cuda.synchronize()
  path_ms = (time.perf_counter() - t0) * 1e3
  counts = dict(sk.launch_counts)
  peak = (torch.cuda.max_memory_allocated() - base_mem) / 2 ** 30
  log(f"  band_sharded_forward + band_sharded_grad: {path_ms:.2f} ms "
      f"(first run), launches {counts}, peak {peak:.3f} GiB above the "
      f"{base_mem / 2 ** 30:.3f} GiB held")
  assert counts == {"stream_forward": 2 * N_SHARDS,
                    "stream_backward": N_SHARDS,
                    "halo_merge": N_SHARDS}, counts
  assert torch.equal(img_fwd, full), "sharded forward image differs"
  assert torch.equal(img_sh, full), "sharded grad's image differs"
  tol_col = 1e-4 * want.abs().amax(0) + 1e-6
  err_col = (got - want).abs().amax(0)
  assert bool(torch.isfinite(got).all())
  assert bool((err_col <= tol_col).all()), (
      "sharded gradient disagrees with the unsharded one", err_col.tolist(),
      tol_col.tolist())
  share = float((err_col / tol_col).max())
  log(f"  headline: sharded image bit for bit the unsharded K1 image; "
      f"per-point gradient max_abs_err {float(err_col.max()):.3e} against "
      f"backward_reduce, worst column at {share:.3f} of K2's tolerance")
  err2 = max(err2, float(err_col.max()))
  del img_fwd, img_sh, want, got

  # each shard's K2 halo buffer against its twin, and the halo merge
  # against its plain twin on those buffers, at the headline's shapes
  _, shards = ss._shards(m, mesh)
  t_local = m.tiles_wide * th_local
  band_rows = m.tiles_wide * m.run_cap
  hbufs, share, twin_ms = [], 0.0, 0.0
  for d, band0, _, lm in shards:
    rows = slice(d * t_local, (d + 1) * t_local)
    hbufs.append(sk.stream_backward(lm, full[rows], g_it[rows], cfg, band0,
                                    halo=True))
    t0 = time.perf_counter()
    twin = sk.stream_backward_reference(lm, full[rows], g_it[rows], cfg,
                                        band0, halo=True)
    torch.cuda.synchronize()
    twin_ms += (time.perf_counter() - t0) * 1e3
    tol_col = 1e-4 * twin.abs().amax(0) + 1e-6
    err_col = (hbufs[-1] - twin).abs().amax(0)
    assert bool((err_col <= tol_col).all()), (
        f"headline shard {d}: K2 halo mode disagrees with its twin",
        err_col.tolist(), tol_col.tolist())
    err2 = max(err2, float(err_col.max()))
    share = max(share, float((err_col / tol_col).max()))
    del twin
  merge_err = 0.0
  for d in range(N_SHARDS):
    above = (hbufs[d - 1][(th_local + 1) * band_rows:(th_local + 2)
                          * band_rows] if d > 0 else None)
    below = hbufs[d + 1][:band_rows] if d < N_SHARDS - 1 else None
    got = sk.halo_merge(hbufs[d].clone(), th_local, band_rows, above, below)
    want = sk.halo_merge_reference(hbufs[d].clone(), th_local, band_rows,
                                   above, below)
    merge_err = max(merge_err, float((got - want).abs().max()))
    assert torch.equal(got, want), f"headline shard {d}: halo merge"
  del hbufs, got, want
  log(f"  headline, each shard's K2 in halo mode against its twin: worst "
      f"column at {share:.3f} of K2's tolerance (twins {twin_ms:.0f} ms in "
      f"all); halo merge max_abs_err {merge_err:.3e} against its plain "
      f"twin on those buffers, every shard")

  # timings: the whole by events, each part staged, each kernel as calls
  whole_ms = cuda_ms(lambda: ss.band_sharded_grad(m, g_it, cfg, mesh), 3)
  names = ([f"{k} s{d}" for d in range(N_SHARDS) for k in ("K1", "K2")]
           + ["halo exchange", "halo merge", "gather + stage 2"])
  for sync in (False, False, True):
    st = Stages(sync)
    st.mark()
    bufs = []
    for d, band0, _, lm in shards:
      img = sk.stream_forward(lm, cfg, band0)
      st.mark()
      bufs.append(sk.stream_backward(
          lm, img, g_it[d * t_local:(d + 1) * t_local], cfg, band0,
          halo=True))
      st.mark()
    top = [b[:band_rows] for b in bufs]
    bot = [b[(th_local + 1) * band_rows:(th_local + 2) * band_rows]
           for b in bufs]
    above = ppermute(mesh, bot, [(i, i + 1) for i in range(N_SHARDS - 1)])
    below = ppermute(mesh, top, [(i, i - 1) for i in range(1, N_SHARDS)])
    st.mark()
    own = [sk.halo_merge(b, th_local, band_rows, above[d], below[d])
           for d, b in enumerate(bufs)]
    st.mark()
    reduce_stage2(all_gather(mesh, own + [bufs[0][-1:]]), m)
    st.mark()
    st.log("band-sharded stages" + (", each alone" if sync else ""), names)
  k1_full = cuda_ms(lambda: sk.stream_forward(m, cfg), 5)
  k2_full = cuda_ms(lambda: sk.stream_backward(m, full, g_it, cfg), 5)
  k1_shards, k2_shards = [], []
  for d, band0, _, lm in shards:
    rows = slice(d * t_local, (d + 1) * t_local)
    k1_shards.append(cuda_ms(lambda: sk.stream_forward(lm, cfg, band0), 5))
    k2_shards.append(cuda_ms(lambda: sk.stream_backward(
        lm, full[rows], g_it[rows], cfg, band0, halo=True), 5))
  log(f"  band_sharded_grad, the whole: {whole_ms:.3f} ms (CUDA events, 3 "
      f"calls)")
  log(f"  K1 per shard (ms, 5 calls each): {[round(t, 4) for t in k1_shards]}"
      f" sum {sum(k1_shards):.3f}; unsharded {k1_full:.3f}")
  log(f"  K2 per shard (ms, 5 calls each): {[round(t, 4) for t in k2_shards]}"
      f" sum {sum(k2_shards):.3f}; unsharded {k2_full:.3f}: the halo costs "
      f"{sum(k2_shards) - k2_full:+.3f} ms")

  # the halo merge alone: a middle shard (both peers), on copies
  buf1 = bufs[1].clone()
  a1, b1 = above[1].clone(), below[1].clone()
  merge_ms = cuda_ms(lambda: sk.halo_merge(buf1, th_local, band_rows, a1,
                                           b1), 5)
  merge_dev = device_ms(lambda: sk.halo_merge(buf1, th_local, band_rows, a1,
                                              b1), kernels=1)
  # as the path finds its bands: written by K2 several ms earlier, out of
  # the 50 MB L2 (a 256 MB fill between calls evicts them)
  flush = torch.empty(64 << 20, device=dev)
  split = device_split(lambda: (flush.zero_(), sk.halo_merge(
      buf1, th_local, band_rows, a1, b1)), kernels=2)
  merge_cold = next(t for k, t in split.items() if "halo_merge" in k)
  del flush
  plain_ms = cuda_ms(lambda: sk.halo_merge_reference(
      buf1, th_local, band_rows, a1, b1), 5)
  band_bytes = nbytes(a1)
  m_ms, m_by = bound_ms(2 * a1.numel(), 6 * band_bytes)
  occ = (ctypes.c_int * 3)()
  assert sk._bwd_kernel().tpu_splat_halo_merge_occupancy(occ) == 0
  log(f"  halo merge (shard 1 of {N_SHARDS}, both peers, bands of "
      f"{band_rows} x {a1.shape[1]} f32 = {band_bytes} B): a call "
      f"{merge_ms:.4f} ms, device {merge_cold:.4f} ms from a flushed L2, "
      f"{merge_dev:.4f} ms with its bands in L2, plain twin "
      f"{plain_ms:.4f} ms, bound {m_ms:.4f} ms ({m_by}: 4 bands read, 2 "
      f"written); {occ[1]} registers, {occ[0] * 8} warps resident per SM")
  del bufs, own, top, bot, above, below, buf1, a1, b1, full, g_it, m

  # 7.3 camera-batch data parallelism at the headline: 4 cameras on 4
  # shards; the reference's data-parallel loss renders (N, C) features,
  # so the SH features are evaluated once at the identity pose (RGB)
  cfg = dataclasses.replace(cfg_caps, compute_visibility=True)
  with torch.no_grad():
    rgb = evaluate_sh_at(g3d.feature, g3d.position, cams[0].camera_position)
  gdp = g3d.replace(feature=rgb.contiguous())
  batch = cams[:N_SHARDS]
  projections = torch.stack([c.projection for c in batch])
  poses = torch.stack([c.T_camera_world for c in batch])
  targets = torch.from_numpy(np.random.default_rng(9).random(
      (N_SHARDS, SIZE_FULL[1], SIZE_FULL[0], 3)).astype(np.float32)).to(dev)
  n = gdp.position.shape[0]
  loss_fn = data_parallel_loss(mesh, cams[0], cfg, max_overlaps=None)
  probe = torch.zeros((n, 1), device=dev, requires_grad=True)
  loss, fwd_vis = loss_fn(gdp, probe, projections, poses, targets)
  (gpr,) = torch.autograd.grad(loss, probe)
  vis = fwd_vis + gpr[:, 0]
  probe1 = torch.zeros((n, 1), device=dev, requires_grad=True)
  losses = []
  for i, c in enumerate(batch):
    out = render_gaussians(gdp, c, cfg, probe=probe1)
    losses.append(torch.mean((out.image - targets[i]) ** 2))
  loss1 = torch.stack(losses).mean()
  (gpr1,) = torch.autograd.grad(loss1, probe1)
  vis1 = gpr1[:, 0]
  dp_loss, loss1 = float(loss.detach()), float(loss1.detach())
  rel = abs(dp_loss - loss1) / abs(loss1)
  vis_err = float((vis - vis1).abs().max())
  vis_tol = 1e-4 * float(vis1.abs().max()) + 1e-6
  log(f"  data parallel, {N_SHARDS} cameras on {N_SHARDS} shards: loss "
      f"{dp_loss:.6f} against the one-device loop's {loss1:.6f} (relative "
      f"{rel:.2e}, tol 1e-5); visibility max_abs_err {vis_err:.3e} (tol "
      f"{vis_tol:.3e}), {int((vis1 > 0).sum())} visible")
  assert rel <= 1e-5 and vis_err <= vis_tol, (rel, vis_err, vis_tol)
  del loss, fwd_vis, gpr, vis, losses, loss1, gpr1, vis1, out

  groups = {"feature": GroupConfig(type="vector", lr=1e-3)}
  step, opt = make_train_step(mesh, cams[0], cfg_caps, groups,
                              max_overlaps=None)
  tensors = {f.name: getattr(gdp, f.name)
             for f in dataclasses.fields(gdp)}
  state = opt.init(tensors)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  sk.reset_launch_counts()
  step_ms, step_losses = [], []
  for i in range(2):
    t0 = time.perf_counter()
    tensors, state, sl = step(tensors, state, projections, poses, targets)
    torch.cuda.synchronize()
    step_ms.append((time.perf_counter() - t0) * 1e3)
    step_losses.append(float(sl))
    assert np.isfinite(step_losses[-1]), step_losses
  dp_peak = torch.cuda.max_memory_allocated() / 2 ** 30
  log(f"  make_train_step, {N_SHARDS} cameras a step: ms "
      f"{[round(t, 3) for t in step_ms]}, losses {step_losses}, launches "
      f"{dict(sk.launch_counts)}, peak {dp_peak:.3f} GiB")
  assert sk.launch_counts["stream_backward"] >= 2 * N_SHARDS
  assert abs(step_losses[0] - dp_loss) <= 1e-6 * abs(dp_loss), (
      step_losses[0], dp_loss)
  del tensors, state, targets, gdp, rgb

  # 7.4 the dry run on the same virtual shards
  dryrun_multichip(N_SHARDS, devices=[dev] * N_SHARDS)
  log(f"  phase 7: {time.perf_counter() - t_phase:.1f} s")
  halo = {"launches": counts["halo_merge"], "max_abs_err": merge_err,
          "ms": merge_ms, "device_ms": merge_cold,
          "device_ms_l2_warm": merge_dev, "plain_ms": plain_ms,
          "bound_ms": m_ms, "bound_by": m_by, "library_ms": None,
          "resident_warps_per_sm": occ[0] * 8,
          "band_sharded_grad_ms": whole_ms}
  k1_extra = {"band_sharded_launches": counts["stream_forward"],
              "band_sharded_max_abs_err": err1}
  k2_extra = {"band_sharded_launches": counts["stream_backward"],
              "band_sharded_max_abs_err": err2,
              "band_sharded_shard_ms_sum": sum(k2_shards),
              "unsharded_ms_same_call": k2_full}
  return halo, k1_extra, k2_extra



# phase 8: one block per tile of the 2048x1536 headline at tile 16
MOSAIC_BLOCKS = (SIZE_FULL[0] // 16) * (SIZE_FULL[1] // 16)


def mosaic_at_scale(dev):
  """Phase 8's inputs at scale, from a seed: {probe: its arguments}.  T1
  (12,288, 256, 16) f32 blocks with d uniform in [-256, 256), so starts
  wrap and clamp; T2 a (786,432, 128) table to rows of 16; T3 a
  (2,097,152, 16) table, g 128, src uniform in [0, P - g); T4 a
  (262,144, 128) table (2,097,152 rows of 16 packed 8 a row), s uniform
  in [0, R - 64]."""
  b = MOSAIC_BLOCKS
  gen = torch.Generator(device=dev).manual_seed(8)
  rng = np.random.default_rng(8)

  def table(*shape):
    return torch.rand(shape, generator=gen, device=dev)

  def ints(lo, hi):
    return torch.from_numpy(rng.integers(lo, hi, b).astype(np.int32)).to(dev)
  return {"T1": (table(b, 256, 16), ints(-256, 256), 128),
          "T2": (table(b * 64, 128), 16),
          "T3": (table(2_097_152, 16), ints(0, 2_097_152 - 128), 128),
          "T4": (table(262_144, 128), ints(0, 262_144 - 64 + 1), 64)}


def rows_needed(starts, width, total):
  """Distinct rows of a ``total``-row table that windows of ``width`` rows
  at ``starts`` (int32) read."""
  mark = torch.zeros(total, dtype=torch.bool, device=starts.device)
  mark[(starts.long()[:, None] + torch.arange(width, device=starts.device))
       .reshape(-1)] = True
  return int(mark.sum())


def timed_in_turns(fns, flush=None, bounds=None, label=""):
  """{name: (ms a call by events over 5 calls, device ms a call)} of
  versions of one function, measured in turns (a, b, ..., b, a); each
  time the mean of its two readings.  ``flush``: (flush, its kernel
  names) from ``l2_flush``; then each device time is ``device_split`` of
  (flush, fn) without the flush's kernels, from a flushed L2.
  ``bounds``: {name: bound_ms(...)} of the versions whose device time is
  held to its bound (``above_bound``, which needs ``flush``), each named
  in its messages as ``label`` and its name."""
  names = list(fns) + list(fns)[::-1]
  got = {k: ([], []) for k in fns}
  for k in names:
    got[k][0].append(cuda_ms(fns[k], 5))
    if flush is None:
      got[k][1].append(device_ms(fns[k]))
    else:
      split = device_split(lambda: (flush[0](), fns[k]()))
      got[k][1].append(sum(t for n, t in split.items() if n not in flush[1]))
  for k, (ms, dev_ms) in got.items():
    log(f"    {k}: a call {ms[0]:.4f} / {ms[1]:.4f} ms, device "
        f"{dev_ms[0]:.4f} / {dev_ms[1]:.4f} ms")
  out = {k: (sum(ms) / 2, sum(dev_ms) / 2) for k, (ms, dev_ms) in
         got.items()}
  for k, bound in (bounds or {}).items():
    out[k] = (out[k][0], above_bound(f"{label} {k}", out[k][1], bound,
                                     fns[k], flush[0]))
  return out


def held(got, want, label):
  """got bit for bit want (a probe kernel against its twin): the max abs
  difference, 0.0."""
  torch.cuda.synchronize()
  assert got.shape == want.shape, (label, got.shape, want.shape)
  assert torch.equal(got, want), f"{label} differs from its twin"
  return float((got - want).abs().max())


def above_bound(label, device, bound, fn, flush):
  """A probe's device time ``device`` (torch.profiler's records of fn()
  from a flushed L2) is no less than its bound, else some of its input
  went unread.  A reading below the bound is held to a second
  instrument, ``span_ms``: below the bound there too, this raises; else
  the profiler's reading was short, and the span, logged, is returned in
  its place.  Returns the device time."""
  from tpu_splatting_torch.utils.benchmarked import span_ms
  if device >= bound[0]:
    return device
  span = span_ms(fn, flush)
  props = torch.cuda.get_device_properties(0)
  assert span >= bound[0], (
      f"{label}: device time {device:.4f} ms (torch.profiler) and "
      f"{span:.4f} ms (CUDA events) below its bound {bound[0]:.4f} ms: some "
      f"of its input went unread, or the L2 flush failed ({props})")
  log(f"  {label}: torch.profiler read {device:.4f} ms, below the bound "
      f"{bound[0]:.4f} ms; CUDA events around flushed calls read {span:.4f} "
      f"ms, which is taken")
  return span


def mosaic_edges(dev, em):
  """T2 and both T4 instantiations bit for bit their twins on edge
  inputs: T2 tables of fewer rows than a chunk, a short last chunk and
  fewer chunks than blocks; T4 starts at 0 and R - 64, repeated, all
  equal, one slab, and slabs taller than a ring stage.  Returns the cases
  held."""
  r = 4096
  x = torch.rand((r, 128), generator=torch.Generator(device=dev)
                 .manual_seed(3), device=dev)

  def ints(*xs):
    return torch.tensor(xs, dtype=torch.int32, device=dev)
  cases = {
      "ends": (2, ints(0, r - 64, 0, r - 64, 17, r - 65), 64),
      "repeated": (13, torch.arange(0, r - 64, 97, dtype=torch.int32,
                                    device=dev).repeat_interleave(9), 64),
      "all_equal": (38, torch.full((300,), 1234, dtype=torch.int32,
                                   device=dev), 64),
      "one_slab": (1, ints(r - 64), 64),
      "tall": (258, ints(0, 5, 3000, 3001, r - 500), 500)}
  for case, (t2_rows, s, rows) in cases.items():
    held(em.reshape_rows(x[:t2_rows], 16),
         em.reshape_rows_reference(x[:t2_rows], 16), f"T2 edge {case}")
    want = em.dma_residue_sum_reference(x, s, rows)
    for bulk in (True, False):
      held(em.dma_residue_sum(x, s, rows, bulk=bulk), want,
           f"T4 edge {case} bulk={bulk}")
  log(f"  T2 and T4 (both instantiations) bit for bit their twins on the "
      f"edge inputs {list(cases)}")
  return list(cases)


def phase_mosaic(dev, launches):
  """Phase 8: the data-movement probes of ``benchmarks/exp_mosaic.py``.
  Each kernel and instantiation bit for bit its twin and the probe's own
  expect on the probe's inputs, then at 12,288 blocks against its twin
  and timed: T1 staged against direct, T2 against the copy of the view,
  T3 against K6 (``layout.window_copy`` with full counts, bit for bit),
  T4 bulk against loads.  ``launches``: the probes' counts after the main
  path's run.  Returns the four entries of the kernels line."""
  from tpu_splatting_torch.benchmarks import exp_mosaic as em
  from tpu_splatting_torch.rasterizer import layout
  log("phase 8: the exp_mosaic probes")
  t_phase = time.perf_counter()
  for key, (args, expect) in em.probe_inputs(dev).items():
    label, fn, variants = em.PROBES[key]
    want = getattr(em, fn.__name__ + "_reference")(*args)
    for kw in variants:
      got = fn(*args, **kw)
      torch.cuda.synchronize()
      assert torch.equal(got, want), (key, kw)
      assert np.array_equal(got.cpu().numpy(), expect), (key, kw)
    log(f"  {label}: OK ({len(variants)} instantiation"
        f"{'s' if len(variants) > 1 else ''}, bit for bit the twin and the "
        "probe's expect)")

  big = mosaic_at_scale(dev)
  entries = {}
  src = "tpu_splatting_torch/csrc/exp_mosaic.cu"

  def entry(name, line, probe_of, err, fn_ms, plain, b, lib, occ, **extra):
    return dict(name=name, route="cuda", source=src,
                replaces=f"benchmarks/exp_mosaic.py:{line}",
                launches=launches[name], max_abs_err=err, ms=fn_ms[0],
                device_ms=fn_ms[1], plain_ms=plain, bound_ms=b[0],
                bound_by=b[1], library_ms=None if lib is None else lib[0],
                library_device_ms=None if lib is None else lib[1],
                resident_warps_per_sm=occ["warps_per_sm"], main_path=False,
                probe_of=probe_of, **extra)

  # T1: staged against direct; torch indexing by a precomputed row index
  x, d, n = big["T1"]
  b, r, c = x.shape
  want = em.dynamic_slice_rows_reference(x, d, n)
  err = max(held(em.dynamic_slice_rows(x, d, n, staged=s), want,
                 f"T1 staged={s}") for s in (True, False))
  flat = ((torch.arange(b, device=dev) * r + em.slice_starts(d, r, n))[:, None]
          + torch.arange(n, device=dev)).reshape(-1)
  xf = x.reshape(-1, c)
  assert torch.equal(xf[flat], want.reshape(-1, c))
  log(f"  T1 at {tuple(x.shape)}, n {n}: staged and direct bit for bit the "
      "twin")
  t = timed_in_turns({
      "staged": lambda: em.dynamic_slice_rows(x, d, n, staged=True),
      "direct": lambda: em.dynamic_slice_rows(x, d, n, staged=False)})
  lib = (cuda_ms(lambda: xf[flat], 5), device_ms(lambda: xf[flat]))
  plain = cuda_ms(lambda: em.dynamic_slice_rows_reference(x, d, n), 5)
  bound = bound_ms(0, 2 * nbytes(want) + nbytes(d))
  occ = {k: em.occupancy(f"T1 {k}", r * c * 4 if k == "staged" else 0)
         for k in ("staged", "direct")}
  log(f"  T1: torch indexing a call {lib[0]:.4f} ms, device {lib[1]:.4f}; "
      f"twin {plain:.4f} ms; bound {bound[0]:.4f} ms ({bound[1]}); device "
      f"time at {bound[0] / t['staged'][1]:.1%} (staged), "
      f"{bound[0] / t['direct'][1]:.1%} (direct) of it; resident warps "
      f"{occ['staged']['warps_per_sm']} / {occ['direct']['warps_per_sm']}")
  entries["T1"] = entry(
      "dynamic_slice_rows", 26, "window_copy", err, t["staged"], plain,
      bound, lib, occ["staged"], instantiation="staged",
      direct_ms=t["direct"][0], direct_device_ms=t["direct"][1],
      direct_resident_warps_per_sm=occ["direct"]["warps_per_sm"])
  del x, d, want, flat, xf

  # T2 and T4 on edge inputs, bit for bit their twins
  edge_checks = mosaic_edges(dev, em)
  flush = l2_flush(dev)

  # T2: the relayout against the copy of the reshaped view, from a
  # flushed L2
  x, w = big["T2"]
  want = em.reshape_rows_reference(x, w)
  err = held(em.reshape_rows(x, w), want, "T2")
  bound = bound_ms(0, 2 * nbytes(x))
  t = timed_in_turns({"kernel": lambda: em.reshape_rows(x, w),
                      "clone": lambda: x.reshape(-1, w).clone()}, flush,
                     {"kernel": bound}, "T2")
  plain = cuda_ms(lambda: em.reshape_rows_reference(x, w), 5)
  occ = em.occupancy("T2", 0)
  log(f"  T2 {tuple(x.shape)} -> {tuple(want.shape)}: bit for bit the twin;"
      f" twin {plain:.4f} ms; bound {bound[0]:.4f} ms ({bound[1]}); device "
      f"time at {bound[0] / t['kernel'][1]:.1%} of it ("
      f"{occ['registers']} registers, {occ['local_bytes']} local bytes, "
      f"{occ['warps_per_sm']} warps resident)")
  entries["T2"] = entry("reshape_rows", 43, "stream_forward", err,
                        t["kernel"], plain, bound, t["clone"], occ,
                        edge_inputs=edge_checks)
  del x, want

  # T3: against K6 with full counts, bit for bit and timed
  x, s3, g = big["T3"]
  want = em.double_block_window_reference(x, s3, g)
  err = held(em.double_block_window(x, s3, g), want, "T3")
  cnt = torch.full_like(s3, g)
  assert torch.equal(layout.window_copy(x, s3, cnt, g),
                     want.reshape(-1, x.shape[1])), "T3 differs from K6"
  idx = s3.long()[:, None] + torch.arange(g, device=dev)
  assert torch.equal(x[idx], want)
  t = timed_in_turns({
      "T3": lambda: em.double_block_window(x, s3, g),
      "K6 window_copy": lambda: layout.window_copy(x, s3, cnt, g)})
  lib = (cuda_ms(lambda: x[idx], 5), device_ms(lambda: x[idx]))
  plain = cuda_ms(lambda: em.double_block_window_reference(x, s3, g), 5)
  need = rows_needed(s3, g, x.shape[0])
  bound = bound_ms(0, need * x.shape[1] * 4 + nbytes(want, s3))
  occ = em.occupancy("T3", 2 * g * x.shape[1] * 4)
  log(f"  T3 at {tuple(x.shape)}, {s3.shape[0]} windows of {g}: bit for "
      f"bit the twin and K6; {need} rows needed; torch indexing a call "
      f"{lib[0]:.4f} ms, device {lib[1]:.4f}; twin {plain:.4f} ms; bound "
      f"{bound[0]:.4f} ms ({bound[1]}); device time at "
      f"{bound[0] / t['T3'][1]:.1%} (T3), "
      f"{bound[0] / t['K6 window_copy'][1]:.1%} (K6) of it; "
      f"{occ['warps_per_sm']} warps resident")
  entries["T3"] = entry(
      "double_block_window", 75, "window_copy", err, t["T3"], plain, bound,
      lib, occ, window_copy_ms=t["K6 window_copy"][0],
      window_copy_device_ms=t["K6 window_copy"][1],
      window_copy_bit_for_bit=True)
  del x, want, idx

  # T4: bulk copies into the ring against per-thread copies, from a
  # flushed L2; the rows its blocks read
  x, s4, rows = big["T4"]
  want = em.dma_residue_sum_reference(x, s4, rows)
  err = max(held(em.dma_residue_sum(x, s4, rows, bulk=k), want,
                 f"T4 bulk={k}") for k in (True, False))
  need = rows_needed(s4, rows, x.shape[0])
  bound = bound_ms(0, need * x.shape[1] * 4 + nbytes(want, s4))
  t = timed_in_turns({
      "bulk": lambda: em.dma_residue_sum(x, s4, rows, bulk=True),
      "loads": lambda: em.dma_residue_sum(x, s4, rows, bulk=False)}, flush,
      {"bulk": bound, "loads": bound}, "T4")
  plain = cuda_ms(lambda: em.dma_residue_sum_reference(x, s4, rows), 5)
  num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
  read = em.residue_rows_read(s4, rows, x.shape[0], num_sms)
  read_ms = bound_ms(0, read * x.shape[1] * 4 + nbytes(want, s4))[0]
  smem4 = em.residue_plan(rows, x.shape[0], num_sms).smem
  occ = {k: em.occupancy(f"T4 {k}", smem4) for k in ("bulk", "loads")}
  log(f"  T4 at {tuple(x.shape)}, {s4.shape[0]} slabs of {rows} rows: bulk "
      f"and loads bit for bit the twin; {need} rows needed, {read} read by "
      f"its blocks ({read - need} boundary rows, {read / need - 1:.1%}; "
      f"the rows read and the output at the card's rate {read_ms:.4f} ms); "
      f"twin {plain:.4f} ms; bound "
      f"{bound[0]:.4f} ms ({bound[1]}); device time at "
      f"{bound[0] / t['bulk'][1]:.1%} (bulk), "
      f"{bound[0] / t['loads'][1]:.1%} (loads) of it; resident warps "
      f"{occ['bulk']['warps_per_sm']} / {occ['loads']['warps_per_sm']}")
  entries["T4"] = entry(
      "dma_residue_sum", 98, "stream_forward", err, t["bulk"], plain, bound,
      None, occ["bulk"], instantiation="bulk", loads_ms=t["loads"][0],
      loads_device_ms=t["loads"][1],
      loads_resident_warps_per_sm=occ["loads"]["warps_per_sm"],
      rows_needed=need, rows_read=read, rows_read_bound_ms=read_ms,
      edge_inputs=edge_checks)
  del x, want, big
  log(f"  phase 8: {time.perf_counter() - t_phase:.1f} s")
  return [entries[k] for k in ("T1", "T2", "T3", "T4")]


# phase 9: a table of 2M rows, as f1_fetch's n, in blocks of s_cap rows
PACK_N, PACK_S_CAP = 2_000_000, 1024


def l2_flush(dev):
  """(flush, its kernel names): flush() writes a buffer of four times the L2
  (``utils.benchmarked.l2_flusher``: ``bitwise_not_`` of int32, a kernel
  no probe and no library call of phase 9 launches)."""
  from tpu_splatting_torch.utils.benchmarked import l2_flusher
  flush = l2_flusher(dev)
  return flush, set(device_split(flush, kernels=1))


def phase_pack(dev, launches):
  """Phase 9: the packed-table probes of ``benchmarks/exp_pack.py``.  On
  the probes' own inputs each kernel, in each order and mode, bit for bit
  its twin and the probe's expect; then at scale from a seed, each held
  to its twin and timed from a flushed L2 beside its bound (a device time
  below the bound raises: slabs would have gone unread): unpack_rows at
  12,288 blocks of 512 rows (w 16 and 11 row-major, 12 column-major)
  against the copy of the reshaped view, slab_relayout over 12,288 slabs
  (flat C 12, packed, flat C 32 as the stream table's padded stride) in
  turns, column_sums over 2M rows in 1,953 blocks (W 11, 12, 32 and
  packed) against ``x.sum(0)``, within 1e-5 of each column's sum of |x|
  and bit for bit a second run.  ``launches``: the probes' counts after
  the main path's run.  Returns the ten entries of the kernels line."""
  from tpu_splatting_torch.benchmarks import exp_pack as ep
  log("phase 9: the exp_pack probes")
  t_phase = time.perf_counter()
  for label, (xp, w, order), expect in ep.unpack_inputs(dev).values():
    got = ep.unpack_rows(xp, w, order)
    torch.cuda.synchronize()
    assert torch.equal(got, ep.unpack_rows_reference(xp, w, order)), label
    assert np.array_equal(got.cpu().numpy(), expect), label
    log(f"  {label}: OK (bit for bit the twin and the probe's x.T)")
  steps = MOSAIC_BLOCKS
  for packed, shape in ((False, (steps * 512, 12)), (True, (steps * 64, 128))):
    x = torch.zeros(shape, device=dev)
    assert torch.equal(ep.slab_relayout(x, packed),
                       torch.zeros((12, 128), device=dev)), packed
  for shape, rows in (((PACK_N, 12), PACK_S_CAP),
                      ((PACK_N // 8, 128), PACK_S_CAP // 8)):
    x = torch.zeros(shape, device=dev)
    assert torch.equal(ep.column_sums(x, rows),
                       torch.zeros((1, shape[1]), device=dev)), shape
  del x
  log(f"  T1 ({steps} slabs) and F1 (n {PACK_N}) on the probes' zero "
      "tables: the twins' zeros, flat and packed")

  flush = l2_flush(dev)
  gen = torch.Generator(device=dev).manual_seed(9)
  src = "tpu_splatting_torch/csrc/exp_pack.cu"
  entries = []

  def entry(name, variant, line, err, fn_ms, plain, b, lib, occ, **extra):
    entries.append(dict(
        name=name, variant=variant, route="cuda", source=src,
        replaces=f"benchmarks/exp_pack.py:{line}", launches=launches[name],
        max_abs_err=err, ms=fn_ms[0], device_ms=fn_ms[1], plain_ms=plain,
        bound_ms=b[0], bound_by=b[1],
        library_ms=None if lib is None else lib[0],
        library_device_ms=None if lib is None else lib[1],
        resident_warps_per_sm=occ["warps_per_sm"], main_path=False,
        probe_of="stream_forward", **extra))

  # unpack_rows against the copy of the reshaped (or permuted) view
  for key, w, order, line in (("U1", 16, "row", 53), ("U1b", 11, "row", 76),
                              ("U2", 12, "col", 100)):
    xp = torch.rand((MOSAIC_BLOCKS, 64, 8 * w), generator=gen, device=dev)
    want = ep.unpack_rows_reference(xp, w, order)
    got = ep.unpack_rows(xp, w, order)
    torch.cuda.synchronize()
    assert torch.equal(got, want), f"unpack_rows {key} differs from its twin"
    del got
    b = xp.shape[0]
    if order == "row":
      view = xp.reshape(b, 512, w).transpose(1, 2)
    else:
      view = xp.reshape(b, 64, w, 8).permute(0, 2, 1, 3)
    bound = bound_ms(0, 2 * nbytes(xp))
    t = timed_in_turns({
        "kernel": lambda: ep.unpack_rows(xp, w, order),
        "library": lambda: view.contiguous()}, flush, {"kernel": bound},
        f"unpack_rows {key}")
    plain = cuda_ms(lambda: ep.unpack_rows_reference(xp, w, order), 5)
    occ = ep.occupancy(f"unpack_rows {order}", ep.unpack_smem(64, w))
    log(f"  unpack_rows {key} (w {w}, {order}) at {tuple(xp.shape)}: bit for "
        f"bit the twin; twin {plain:.4f} ms; bound {bound[0]:.4f} ms "
        f"({bound[1]}); device time at {bound[0] / t['kernel'][1]:.1%} "
        f"(kernel), {bound[0] / t['library'][1]:.1%} (library) of it; "
        f"{occ['registers']} registers, {occ['local_bytes']} local bytes, "
        f"{occ['warps_per_sm']} warps resident")
    entry("unpack_rows", f"{key} w {w} {order}", line, 0.0, t["kernel"],
          plain, bound, t["library"], occ)
    del xp, want, view

  # slab_relayout: flat C 12, packed, flat at the stream table's stride
  slabs = {"flat C 12": (torch.rand((steps * 512, 12), generator=gen,
                                    device=dev), False, 130),
           "packed": (torch.rand((steps * 64, 128), generator=gen,
                                 device=dev), True, 138),
           "flat C 32": (torch.rand((steps * 512, 32), generator=gen,
                                    device=dev), False, 130)}
  for k, (x, packed, _) in slabs.items():
    assert torch.equal(ep.slab_relayout(x, packed),
                       ep.slab_relayout_reference(x, packed)), k
  bounds = {k: bound_ms(0, nbytes(x) + 12 * 128 * 4)
            for k, (x, _, _) in slabs.items()}
  t = timed_in_turns({k: (lambda x=x, p=p: ep.slab_relayout(x, p))
                      for k, (x, p, _) in slabs.items()}, flush, bounds,
                     "slab_relayout")
  others = {}
  for k, (x, packed, line) in slabs.items():
    plain = cuda_ms(lambda: ep.slab_relayout_reference(x, packed), 5)
    bound = bounds[k]
    occ = ep.occupancy(f"slab_relayout {'packed' if packed else 'flat'}",
                       ep.slab_smem(x.shape[1], packed))
    log(f"  slab_relayout {k} at {tuple(x.shape)}: bit for bit the twin (the "
        f"last slab's block); twin {plain:.4f} ms; bound {bound[0]:.4f} ms "
        f"({bound[1]}); device time at {bound[0] / t[k][1]:.1%} of it; "
        f"{occ['registers']} registers, {occ['warps_per_sm']} warps resident")
    others[k] = dict(ms=t[k][0], device_ms=t[k][1])
    entry("slab_relayout", k, line, 0.0, t[k], plain, bound, None, occ)
  for e in entries[-3:]:
    e["in_turns_with"] = {k: v for k, v in others.items()
                          if k != e["variant"]}
  del slabs

  # column_sums over the covered rows against x.sum(0)
  for k, w, rows, line in (("flat W 12", 12, PACK_S_CAP, 169),
                           ("packed", 128, PACK_S_CAP // 8, 177),
                           ("dense W 11", 11, PACK_S_CAP, 169),
                           ("padded W 32", 32, PACK_S_CAP, 169)):
    n = PACK_N // 8 if w == 128 else PACK_N
    x = torch.randn((n, w), generator=gen, device=dev)
    g = n // rows
    covered = x[:g * rows]
    got = ep.column_sums(x, rows)
    again = ep.column_sums(x, rows)
    want = ep.column_sums_reference(x, rows)
    torch.cuda.synchronize()
    assert torch.equal(got, again), f"column_sums {k}: two runs differ"
    scale = covered.abs().sum(0, keepdim=True)
    err = float((got - want).abs().max())
    assert bool(((got - want).abs() <= 1e-5 * scale).all()), (k, err)
    bound = bound_ms(covered.numel(), nbytes(covered) + 4 * w)
    t = timed_in_turns({
        "kernel": lambda: ep.column_sums(x, rows),
        "library": lambda: covered.sum(0)}, flush, {"kernel": bound},
        f"column_sums {k}")
    plain = cuda_ms(lambda: ep.column_sums_reference(x, rows), 5)
    occ = ep.occupancy("column_partials", 0)
    split = device_split(lambda: ep.column_sums(x, rows), kernels=2)
    log(f"  column_sums {k} at {tuple(x.shape)}, {g} blocks of {rows} rows: "
        f"within 1e-5 of each column's sum of |x| of the twin (max abs "
        f"{err:.3e}), bit for bit a second run; twin {plain:.4f} ms; bound "
        f"{bound[0]:.4f} ms ({bound[1]}); device time at "
        f"{bound[0] / t['kernel'][1]:.1%} (kernel), "
        f"{bound[0] / t['library'][1]:.1%} (x.sum(0)) of it; the passes "
        + ", ".join(f"{short_kernel_name(n)} {v:.4f}" for n, v in
                    split.items())
        + f" ms; {occ['warps_per_sm']} warps resident")
    entry("column_sums", k, line, err, t["kernel"], plain, bound,
          t["library"], occ, blocks=g, deterministic=True)
    del x, covered
  log(f"  phase 9: {time.perf_counter() - t_phase:.1f} s")
  return entries



def phase_pack2(dev, launches):
  """Phase 10: the packed-table probes of ``benchmarks/exp_pack2.py``.  On
  the probes' own inputs each kernel, in each mode, bit for bit its twin
  and the probe's expect (V_a ``rows.T`` in ``perm_cprime`` order, V_b
  ``np.tile`` / ``np.repeat``, V_c ``rows.T``, V_p ``x[:, inv]``), and
  T2's three kernels the last slab's block of 4 seeded slabs; then at
  12,288 blocks from a seed, each held to its twin bit for bit and timed
  from a flushed L2 beside its bound (a device time below the bound
  raises): ``permuted_unpack`` in turns with ``unpack_direct``, exp_pack's
  staged ``unpack_rows`` and the copies of the permuted and transposed
  views; ``repeat_rows`` (tile, element) with ``x.repeat`` /
  ``repeat_interleave``; ``permute_lanes`` on a (12,288, 16, 512)
  gradient with ``index_select``; ``slab_relayout_permuted`` with
  ``exp_pack.slab_relayout`` flat C 12 and packed.  ``launches``: the
  probes' counts after the main path's run.  Returns the six entries of
  the kernels line."""
  from tpu_splatting_torch.benchmarks import exp_pack as ep
  from tpu_splatting_torch.benchmarks import exp_pack2 as ep2
  log("phase 10: the exp_pack2 probes")
  t_phase = time.perf_counter()
  rows, xr, gr = ep2.probe_rows(), ep2.probe_repeat_input(), \
      ep2.probe_gradient()
  perm_np = ep2.perm_cprime()
  inv = np.empty(512, np.int64)
  inv[perm_np] = np.arange(512)
  perm = torch.as_tensor(perm_np, dtype=torch.int32)
  xp = torch.as_tensor(rows.reshape(1, 64, 128), device=dev)
  x = torch.as_tensor(xr[None], device=dev)
  g = torch.as_tensor(gr[None], device=dev)
  for label, got, twin, expect in (
      ("V_a permuted_unpack", ep2.permuted_unpack(xp, 16),
       ep2.permuted_unpack_reference(xp, 16), rows.T[:, perm_np]),
      ("V_b repeat_rows tile", ep2.repeat_rows(x, 2),
       ep2.repeat_rows_reference(x, 2), np.tile(xr, (2, 1))),
      ("V_b repeat_rows element", ep2.repeat_rows(x, 2, "element"),
       ep2.repeat_rows_reference(x, 2, "element"), np.repeat(xr, 2, 0)),
      ("V_c unpack_direct", ep2.unpack_direct(xp, 16),
       ep2.unpack_direct_reference(xp, 16), rows.T),
      ("V_p permute_lanes", ep2.permute_lanes(g, perm),
       ep2.permute_lanes_reference(g, perm), gr[:, inv])):
    torch.cuda.synchronize()
    assert torch.equal(got, twin), f"{label} differs from its twin"
    assert np.array_equal(got[0].cpu().numpy(), expect), label
    log(f"  {label}: OK (bit for bit the twin and the probe's expect)")
  gen = torch.Generator(device=dev).manual_seed(10)
  x_flat = torch.rand((4 * 512, 12), generator=gen, device=dev)
  x_pack = torch.rand((4 * 64, 128), generator=gen, device=dev)
  last = x_pack[-64:].reshape(512, 16).cpu().numpy()
  for label, got, want in (
      ("today", ep.slab_relayout(x_flat),
       x_flat[-512:].cpu().numpy().T[:12, :128]),
      ("V_a", ep2.slab_relayout_permuted(x_pack),
       last.T[:, perm_np][:12, :128]),
      ("V_c", ep.slab_relayout(x_pack, packed=True), last.T[:12, :128])):
    assert np.array_equal(got.cpu().numpy(), want), f"T2 {label}"
  log("  T2's three kernels (today, V_a, V_c) on 4 seeded slabs: the last "
      "slab's block")

  flush = l2_flush(dev)
  b = MOSAIC_BLOCKS
  src = "tpu_splatting_torch/csrc/exp_pack2.cu"
  entries = []

  def entry(name, variant, line, fn_ms, plain, bnd, lib, occ, probe_of,
            **extra):
    entries.append(dict(
        name=name, variant=variant, route="cuda", source=src,
        replaces=f"benchmarks/exp_pack2.py:{line}", main_path=False,
        launches=launches[name], max_abs_err=0.0, ms=fn_ms[0],
        device_ms=fn_ms[1], plain_ms=plain, bound_ms=bnd[0],
        bound_by=bnd[1], library_ms=None if lib is None else lib[0],
        library_device_ms=None if lib is None else lib[1],
        resident_warps_per_sm=occ["warps_per_sm"], probe_of=probe_of,
        **extra))

  def occ_log(occ):
    return (f"{occ['registers']} registers, {occ['local_bytes']} local "
            f"bytes, {occ['warps_per_sm']} warps resident")

  # the unpacks at w 16: permuted, direct and exp_pack's staged, in turns
  xp = torch.rand((b, 64, 128), generator=gen, device=dev)
  held(ep2.permuted_unpack(xp, 16), ep2.permuted_unpack_reference(xp, 16),
       "permuted_unpack")
  direct = ep2.unpack_direct(xp, 16)
  held(direct, ep2.unpack_direct_reference(xp, 16), "unpack_direct")
  held(direct, ep.unpack_rows(xp, 16), "unpack_direct vs unpack_rows")
  del direct
  bnd = bound_ms(0, 2 * nbytes(xp))
  t = timed_in_turns({
      "permuted_unpack": lambda: ep2.permuted_unpack(xp, 16),
      "unpack_direct": lambda: ep2.unpack_direct(xp, 16),
      "unpack_rows": lambda: ep.unpack_rows(xp, 16),
      "permuted view copy": lambda: xp.view(b, 64, 8, 16).permute(
          0, 3, 2, 1).reshape(b, 16, 512),
      "transposed view copy": lambda: xp.view(b, 512, 16).transpose(
          1, 2).contiguous()}, flush,
      {"permuted_unpack": bnd, "unpack_direct": bnd}, "w 16")
  turns = {k: dict(ms=v[0], device_ms=v[1]) for k, v in t.items()}
  for name, line, lib, smem in (
      ("permuted_unpack", 65, "permuted view copy", ep2.permuted_smem(64, 16)),
      ("unpack_direct", 129, "transposed view copy", 0)):
    twin = getattr(ep2, name + "_reference")
    plain = cuda_ms(lambda: twin(xp, 16), 5)
    occ = ep2.occupancy(name, smem)
    log(f"  {name} (w 16) at {tuple(xp.shape)}: bit for bit the twin; twin "
        f"{plain:.4f} ms; bound {bnd[0]:.4f} ms ({bnd[1]}); device time at "
        f"{bnd[0] / t[name][1]:.1%} of it (library {lib} "
        f"{bnd[0] / t[lib][1]:.1%}); {occ_log(occ)}")
    entry(name, "w 16", line, t[name], plain, bnd, t[lib], occ,
          "stream_forward",
          in_turns_with={k: v for k, v in turns.items() if k != name})
  log(f"  the H100 answer: permuted {t['permuted_unpack'][1]:.4f} ms, "
      f"direct {t['unpack_direct'][1]:.4f}, staged fetch order (unpack_rows) "
      f"{t['unpack_rows'][1]:.4f} ms of device time; permuted over staged "
      f"{t['permuted_unpack'][1] / t['unpack_rows'][1]:.3f}x")
  del xp

  # repeat_rows, n 2, both modes, against x.repeat / repeat_interleave
  x = torch.rand((b, 64, 128), generator=gen, device=dev)
  for mode in ep2.MODES:
    held(ep2.repeat_rows(x, 2, mode), ep2.repeat_rows_reference(x, 2, mode),
         f"repeat_rows {mode}")
  bnd = bound_ms(0, 3 * nbytes(x))
  t = timed_in_turns({
      "tile": lambda: ep2.repeat_rows(x, 2),
      "element": lambda: ep2.repeat_rows(x, 2, "element"),
      "x.repeat": lambda: x.repeat(1, 2, 1),
      "x.repeat_interleave": lambda: x.repeat_interleave(2, 1)}, flush,
      {"tile": bnd, "element": bnd}, "repeat_rows n 2")
  for mode, lib in (("tile", "x.repeat"), ("element", "x.repeat_interleave")):
    plain = cuda_ms(lambda: ep2.repeat_rows_reference(x, 2, mode), 5)
    occ = ep2.occupancy(f"repeat_rows {mode}", 0)
    log(f"  repeat_rows {mode} (n 2) at {tuple(x.shape)}: bit for bit the "
        f"twin; twin {plain:.4f} ms; bound {bnd[0]:.4f} ms ({bnd[1]}); "
        f"device time at {bnd[0] / t[mode][1]:.1%} of it ({lib} "
        f"{bnd[0] / t[lib][1]:.1%}); {occ_log(occ)}")
    entry("repeat_rows", f"{mode} n 2", 86, t[mode], plain, bnd, t[lib], occ,
          "stream_forward")
  del x

  # permute_lanes on a (12,288, 16, 512) gradient, the probe's perm
  gx = torch.randn((b, 16, 512), generator=gen, device=dev)
  inv_dev = torch.as_tensor(inv, device=dev)
  got = ep2.permute_lanes(gx, perm)
  held(got, ep2.permute_lanes_reference(gx, perm), "permute_lanes")
  held(got, gx[..., inv_dev], "permute_lanes vs x[..., inv]")
  del got
  bnd = bound_ms(0, 2 * nbytes(gx) + nbytes(inv_dev) // 2)
  t = timed_in_turns({
      "kernel": lambda: ep2.permute_lanes(gx, perm),
      "index_select": lambda: gx.index_select(-1, inv_dev)}, flush,
      {"kernel": bnd}, "permute_lanes")
  plain = cuda_ms(lambda: ep2.permute_lanes_reference(gx, perm), 5)
  occ = ep2.occupancy("permute_lanes", ep2.lane_smem(512))
  log(f"  permute_lanes at {tuple(gx.shape)} (perm_cprime): bit for bit the "
      f"twin and x[..., inv]; twin {plain:.4f} ms; bound {bnd[0]:.4f} ms "
      f"({bnd[1]}); device time at {bnd[0] / t['kernel'][1]:.1%} of it "
      f"(index_select {bnd[0] / t['index_select'][1]:.1%}); {occ_log(occ)}")
  entry("permute_lanes", "(12288, 16, 512) perm_cprime", 167, t["kernel"],
        plain, bnd, t["index_select"], occ, "stream_backward")
  del gx

  # T2: V_a's relayout in turns with today's and V_c's (exp_pack)
  x_flat = torch.rand((b * 512, 12), generator=gen, device=dev)
  x_pack = torch.rand((b * 64, 128), generator=gen, device=dev)
  held(ep2.slab_relayout_permuted(x_pack),
       ep2.slab_relayout_permuted_reference(x_pack), "slab_relayout_permuted")
  bnd = bound_ms(0, nbytes(x_pack) + 12 * 128 * 4)
  t = timed_in_turns({
      "V_a": lambda: ep2.slab_relayout_permuted(x_pack),
      "today flat C 12": lambda: ep.slab_relayout(x_flat),
      "V_c packed": lambda: ep.slab_relayout(x_pack, packed=True)}, flush,
      {"V_a": bnd}, "T2 slab_relayout_permuted")
  plain = cuda_ms(lambda: ep2.slab_relayout_permuted_reference(x_pack), 5)
  occ = ep2.occupancy("slab_relayout_permuted", ep2.permuted_smem(64, 16))
  log(f"  T2 over {b} slabs: V_a slab_relayout_permuted bit for bit its twin;"
      f" twin {plain:.4f} ms; bound {bnd[0]:.4f} ms ({bnd[1]}); device time "
      f"at {bnd[0] / t['V_a'][1]:.1%} of it (V_c packed "
      f"{bnd[0] / t['V_c packed'][1]:.1%}); {occ_log(occ)}")
  entry("slab_relayout_permuted", f"{b} slabs", 212, t["V_a"], plain, bnd,
        None, occ, "stream_forward",
        in_turns_with={k: dict(ms=v[0], device_ms=v[1])
                       for k, v in t.items() if k != "V_a"})
  del x_flat, x_pack
  log(f"  phase 10: {time.perf_counter() - t_phase:.1f} s")
  return entries


# phase 11: tests/test_fit_image.py's configurations, and the example's
# default size
FIT_FAST = ["--n", "120", "--iters", "10", "--epoch", "5", "--max_epoch",
            "5", "--image_size", "48,32", "--max_overlaps", "4096"]
FIT_CONVERGE = ["--n", "200", "--iters", "40", "--epoch", "10", "--max_epoch",
                "20", "--image_size", "64,48", "--prune", "--max_overlaps",
                "16384", "--debug"]
FIT_ANTIALIAS = ["--n", "100", "--iters", "20", "--epoch", "10",
                 "--image_size", "48,32", "--antialias", "--max_overlaps",
                 "8192"]
FIT_DEFAULT = ["--n", "1000", "--iters", "500", "--image_size", "256,192"]


def fit_step_vs_cpu(dev, size, n):
  """One ``renderer2d.render_with_heuristics`` step of seeded splats on
  the card (K1, K2) and on the CPU (twins), with the trainer's loss and
  calibrated config: image within TOL, loss within 1e-5, each gradient
  leaf, the heuristics and the visibility within 1e-3 of its largest
  magnitude (F8)."""
  from tpu_splatting_torch import RasterConfig
  from tpu_splatting_torch.examples import fit_image_gaussians as fit
  from tpu_splatting_torch.misc.renderer2d import render_with_heuristics
  from tpu_splatting_torch.optim import ParameterClass
  from tpu_splatting_torch.rasterizer import stream_kernels as sk
  g = fit.random_gaussians2d(torch.Generator().manual_seed(11), n, size,
                             device="cpu")
  params = ParameterClass.create(
      {f.name: getattr(g, f.name) for f in dataclasses.fields(g)},
      fit.make_parameter_groups(0.5))
  cfg = fit.autosize_stream_caps(RasterConfig(**HEUR), params, size)
  target = fit.load_image(fit.parse_args(["--image_size",
                                          f"{size[0]},{size[1]}"]), "cpu")
  w, h = size
  out = []
  for d in (dev, torch.device("cpu")):
    gd = g.replace(**{f.name: getattr(g, f.name).to(d)
                      for f in dataclasses.fields(g)})
    tgt = target.to(d)

    def loss_fn(r, gg, tgt=tgt):
      scale = torch.exp(gg.log_scaling) / min(w, h)
      return (torch.mean((r.image - tgt) ** 2) + 1e-2 * torch.mean(
          gg.opacity) + 0.1 * torch.mean(scale ** 2))
    sk.reset_launch_counts()
    out.append(render_with_heuristics(loss_fn, gd, size, cfg))
    want = 1 if d.type == "cuda" else 0
    assert sk.launch_counts["stream_forward"] == want, sk.launch_counts
    assert sk.launch_counts["stream_backward"] == want, sk.launch_counts
  (l_gpu, o_gpu, d_gpu), (l_cpu, o_cpu, d_cpu) = out
  assert int(o_gpu.num_overflow) == 0 and int(o_cpu.num_overflow) == 0
  err = max(float((o_gpu.image.cpu() - o_cpu.image).abs().max()),
            float((o_gpu.image_weight.cpu() - o_cpu.image_weight).abs()
                  .max()))
  assert err <= TOL, f"fit step {size}: image differs by {err:.3e}"
  assert abs(float(l_gpu) - float(l_cpu)) <= 1e-5, (float(l_gpu),
                                                    float(l_cpu))
  worst = 0.0
  pairs = [(f.name, getattr(d_gpu, f.name), getattr(d_cpu, f.name))
           for f in dataclasses.fields(d_cpu)]
  pairs += [("point_heuristic", o_gpu.point_heuristic, o_cpu.point_heuristic),
            ("visibility", o_gpu.visibility, o_cpu.visibility)]
  for name, a, c in pairs:
    a = a.cpu()
    assert torch.isfinite(a).all(), name
    scale = float(c.abs().max())
    rel = float((a - c).abs().max()) / max(scale, 1e-30)
    assert rel <= 1e-3 or scale == 0, (name, rel)
    worst = max(worst, rel if scale else 0.0)
  log(f"  render_with_heuristics {size[0]}x{size[1]}, {n} splats: card vs "
      f"CPU image max abs {err:.3e}, loss {float(l_gpu):.7f} / "
      f"{float(l_cpu):.7f}, worst gradient / heuristic leaf {worst:.2e} of "
      "its scale")


def phase_fit(dev, card):
  """Phase 11: P11's fit-image training path on the card, from
  ``tpu_splatting_torch`` alone.  ``render_with_heuristics`` 2D against
  the CPU twins at 48x32 (120 splats) and 256x192 (1000); the trainer's
  ``main`` at tests/test_fit_image.py's fast config on the card and on the
  CPU from one seed (PSNR > 10 each, within 0.5 dB), its converge (> 15)
  and antialias (> 12) configs on the card; then the example's default
  size, 256x192 with 1000 splats for 500 iterations (PSNR > 15), with the
  median step time by CUDA events and K1's and K2's launches, which must
  equal the steps.  Returns {kernel: launches on that run}."""
  from tpu_splatting_torch.examples import fit_image_gaussians as fit
  from tpu_splatting_torch.rasterizer import stream_kernels as sk
  log("phase 11: fit-image training (tpu_splatting_torch.examples."
      "fit_image_gaussians)")
  t_phase = time.perf_counter()
  for size, n in (((48, 32), 120), ((256, 192), 1000)):
    fit_step_vs_cpu(dev, size, n)
  card_psnr, cpu_psnr = (fit.main(FIT_FAST + ["--device", str(d)])
                         for d in (dev, "cpu"))
  log(f"  fast config: PSNR card {card_psnr:.3f}, CPU {cpu_psnr:.3f}")
  assert min(card_psnr, cpu_psnr) > 10, (card_psnr, cpu_psnr)
  assert abs(card_psnr - cpu_psnr) <= 0.5, (card_psnr, cpu_psnr)
  for label, args, floor in (("converge", FIT_CONVERGE, 15),
                             ("antialias", FIT_ANTIALIAS, 12)):
    p = fit.main(args + ["--device", str(dev)])
    log(f"  {label} config: PSNR card {p:.3f} (floor {floor})")
    assert p > floor, (label, p)

  events, last = [], []
  real_step = fit.train_step

  def timed_step(*args, **kw):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = real_step(*args, **kw)
    end.record()
    events.append((start, end, out[0]["position"].shape[0]))
    last[:] = [args, kw]
    return out
  fit.train_step = timed_step
  try:
    sk.reset_launch_counts()       # the slice's main path: from zero
    t0 = time.perf_counter()
    p = fit.main(FIT_DEFAULT + ["--device", str(dev)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(sk.launch_counts)
  finally:
    fit.train_step = real_step
  steps = len(events)
  ms = sorted(a.elapsed_time(b) for a, b, _ in events)
  assert launches["stream_forward"] == steps == 500, (launches, steps)
  assert launches["stream_backward"] == steps, (launches, steps)
  log(f"  default size 256x192, 1000 splats, {steps} steps: PSNR {p:.3f} "
      f"(floor 15); step median {ms[len(ms) // 2]:.3f} ms by CUDA events "
      f"(min {ms[0]:.3f}, max {ms[-1]:.3f}); {events[-1][2]} splats at the "
      f"end; K1 {launches['stream_forward']} and K2 "
      f"{launches['stream_backward']} launches; {wall:.1f} s of wall clock "
      f"with its calibration; on {card}")
  assert p > 15, p

  # where a step's time goes: the last step again, its kernels' device
  # time against its time by events.  On some machines every profiling
  # session of this step (~760 kernels a call) loses the same record or
  # two; sessions of fewer calls are tried next, and a split that no
  # session gives whole is not measured.
  args, kw = last
  call = cuda_ms(lambda: real_step(*args, **kw), 5)
  for reps in (5, 2):
    try:
      split = device_split(lambda: real_step(*args, **kw), reps=reps)
      break
    except AssertionError as e:
      log(f"  device split over {reps} calls: {str(e)[:90]}...")
  else:
    log(f"  the last step again: {call:.3f} ms a step by events over 5; "
        f"its device split not measured (torch.profiler lost records)")
    log(f"  phase 11: {time.perf_counter() - t_phase:.1f} s")
    return {"stream_forward": launches["stream_forward"],
            "stream_backward": launches["stream_backward"]}
  busy = sum(split.values())
  k1 = sum(v for k, v in split.items() if "stream_forward" in k)
  k2 = sum(v for k, v in split.items() if "stream_backward" in k)
  top = sorted(split.items(), key=lambda kv: -kv[1])[:4]
  log(f"  the last step again: {call:.3f} ms a step by events over 5; "
      f"device busy {busy:.3f} ms ({busy / call:.1%}, idle "
      f"{1 - busy / call:.1%}) in {len(split)} kernels; K1 {k1:.4f} ms, K2 "
      f"{k2:.4f} ms; the longest: " + ", ".join(
          f"{short_kernel_name(k)} {v:.4f}" for k, v in top))
  log(f"  phase 11: {time.perf_counter() - t_phase:.1f} s")
  return {"stream_forward": launches["stream_forward"],
          "stream_backward": launches["stream_backward"]}


@contextlib.contextmanager
def recorded_stream_calls(direct=False):
  """Records every K1 and K2 call made through
  ``rasterizer.stream_function`` while open (with ``direct``, also those
  made through ``rasterizer.stream_kernels``' own names), with its inputs
  and output: {"K1": [(mapping, config, image)], "K2": [(mapping, image,
  g_image, config, buffer)]}.  The recorder launches nothing itself."""
  from tpu_splatting_torch.rasterizer import stream_function as sf
  from tpu_splatting_torch.rasterizer import stream_kernels as sk
  calls = {"K1": [], "K2": []}
  modules = (sf, sk) if direct else (sf,)
  saved = [(mod, mod.stream_forward, mod.stream_backward) for mod in modules]

  def recorders(fwd, bwd):
    # kept detached: a kept output of the autograd graph would keep the
    # graph's saved tensors alive
    def forward(mapping, config):
      out = fwd(mapping, config)
      calls["K1"].append((mapping, config, out.detach()))
      return out

    def backward(mapping, image, g_image, config):
      out = bwd(mapping, image, g_image, config)
      calls["K2"].append((mapping, image.detach(), g_image.detach(), config,
                          out.detach()))
      return out
    return forward, backward
  for mod, fwd, bwd in saved:
    mod.stream_forward, mod.stream_backward = recorders(fwd, bwd)
  try:
    yield calls
  finally:
    for mod, fwd, bwd in saved:
      mod.stream_forward, mod.stream_backward = fwd, bwd


def mapping_equal(a, b):
  """Whether two stream mappings hold the same tensors and metadata."""
  if a is b:
    return True
  for f in dataclasses.fields(a):
    x, y = getattr(a, f.name), getattr(b, f.name)
    if isinstance(x, torch.Tensor):
      if x.shape != y.shape or not torch.equal(x, y):
        return False
    elif x != y:
      return False
  return True


@torch.no_grad()
def stream_calls_vs_twins(calls, label):
  """Every recorded K1 and K2 launch against its twin on its own inputs:
  K1 max abs <= TOL, K2 per column <= 1e-4 * max |twin column| + 1e-6,
  as kernel_vs_twin and backward_vs_twin hold them.  Launches on equal
  inputs (the same config, and equal mapping, image and cotangent
  tensors) share one twin run.  Returns the largest K1 and K2 errors."""
  from tpu_splatting_torch.rasterizer import stream_kernels as sk
  e1 = e2 = 0.0
  twins = []
  for mapping, config, out in calls["K1"]:
    for tm, tc, want in twins:
      if tc == config and mapping_equal(tm, mapping):
        break
    else:
      want = sk.stream_forward_reference(mapping, config)
      twins.append((mapping, config, want))
    err = float((out - want).abs().max())
    assert bool(torch.isfinite(out).all()) and err <= TOL, (label, err)
    e1 = max(e1, err)
  n1, twins = len(twins), []
  worst = 0.0
  for mapping, image, g_image, config, out in calls["K2"]:
    for tm, ti, tg, tc, want in twins:
      if (tc == config and torch.equal(ti, image) and torch.equal(tg, g_image)
          and mapping_equal(tm, mapping)):
        break
    else:
      want = sk.stream_backward_reference(mapping, image, g_image, config)
      twins.append((mapping, image, g_image, config, want))
    err_col = (out - want).abs().amax(0)
    tol_col = 1e-4 * want.abs().amax(0) + 1e-6
    assert bool((err_col <= tol_col).all()), (label, err_col.tolist())
    e2 = max(e2, float(err_col.max()))
    worst = max(worst, float((err_col / tol_col).max()))
  log(f"  {label}: {len(calls['K1'])} K1 launches ({n1} distinct inputs) "
      f"max_abs_err {e1:.3e} (tol {TOL:g}); {len(calls['K2'])} K2 launches "
      f"({len(twins)} distinct inputs) max_abs_err {e2:.3e}, worst column "
      f"at {worst:.3f} of its tolerance; each against its twin")
  return e1, e2


def phase_ply(dev, g3d, cams, cfg, image0, card):
  """Phase 12: the checkpoint-render path (``io.ply`` ->
  ``render_gaussians(use_sh=True)``) at the headline's full width, Morton
  order at 2M points, and the three examples on the card, each held
  against the same example with ``--device cpu``.
  Returns {kernel: {"ply_launches": .., "examples_launches": ..}}."""
  import shutil
  import tempfile
  from tpu_splatting_torch.examples import render_ply, test_backward, vis_split
  from tpu_splatting_torch.io import ply
  from tpu_splatting_torch.misc.morton import argsort_morton
  from tpu_splatting_torch.rasterizer import stream_kernels as sk
  from tpu_splatting_torch.renderer import render_gaussians
  from tpu_splatting_torch.utils import cuda_build
  from tpu_splatting_torch.utils.benchmarked import benchmarked

  log(f"phase 12: checkpoint PLY -> render at {N_FULL} splats {SIZE_FULL} "
      "SH degree 3, Morton order, the examples")
  t_phase = time.perf_counter()
  names = [f.name for f in dataclasses.fields(g3d)]
  tmp = tempfile.mkdtemp(prefix="chip_smoke_ply_")
  try:
    # (a) save phase 3's scene, read it back natively and through numpy
    t0 = time.perf_counter()
    cuda_build.load_host_library("ply_io.cpp")
    log(f"  g++ build of ply_io.cpp: {time.perf_counter() - t0:.2f} s")
    path = os.path.join(tmp, "headline.ply")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ply.save_gaussians(path, g3d)
    t_save = time.perf_counter() - t0
    size = os.path.getsize(path)
    props = 3 + 3 + 3 * 16 + 1 + 3 + 4
    assert size > N_FULL * props * 4, size
    t0 = time.perf_counter()
    raw = ply.read_ply_raw(path)
    t_read = time.perf_counter() - t0
    t0 = time.perf_counter()
    ply._gaussians_from_props(raw, "cpu")
    t_assemble = time.perf_counter() - t0
    t0 = time.perf_counter()
    raw_np = ply._read_ply_raw_numpy(path)
    t_read_np = time.perf_counter() - t0
    assert list(raw) == list(raw_np) and len(raw) == props, list(raw)
    for k in raw:
      assert np.array_equal(raw[k], raw_np[k]), k
    del raw, raw_np
    t0 = time.perf_counter()
    on_cpu = ply.load_gaussians(path, device="cpu")
    t_load_cpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    copied = on_cpu.replace(**{k: getattr(on_cpu, k).to(dev) for k in names})
    torch.cuda.synchronize()
    t_h2d = time.perf_counter() - t0
    del on_cpu, copied
    t0 = time.perf_counter()
    loaded = ply.load_gaussians(path, device=dev)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded_np = ply._gaussians_from_props(ply._read_ply_raw_numpy(path), dev)
    torch.cuda.synchronize()
    t_load_np = time.perf_counter() - t0
    for k in names:
      want = getattr(g3d, k)
      for label, g in (("native", loaded), ("numpy", loaded_np)):
        got = getattr(g, k)
        assert got.is_cuda and got.shape == want.shape, (label, k)
        assert torch.equal(got, want), (label, k)
    del loaded_np
    log(f"  PLY of {N_FULL} splats, {props} float properties: {size} bytes "
        f"({size / 2 ** 20:.1f} MiB); save {t_save:.3f} s (from the card); "
        f"read native {t_read:.3f} s, numpy {t_read_np:.3f} s (to host "
        f"arrays, the file in the page cache); _gaussians_from_props on the "
        f"native table to the host {t_assemble:.3f} s; load_gaussians to the "
        f"host {t_load_cpu:.3f} s, host to device {t_h2d:.3f} s; "
        f"load_gaussians onto the card native {t_load:.3f} s, through numpy "
        f"{t_load_np:.3f} s; both loads bit for bit the scene")

    # the identity pose, phase 3's capacities: phase 3's image again
    cam = cams[0]
    sk.reset_launch_counts()       # the slice's path: from zero
    with torch.no_grad():
      r = render_gaussians(loaded, cam, cfg, use_sh=True)
    torch.cuda.synchronize()
    ply_launches = dict(sk.launch_counts)
    assert int(r.num_overflow) == 0, r.overflow_by_cause.tolist()
    assert torch.isfinite(r.image).all()
    assert ply_launches["stream_forward"] == 1, ply_launches
    err = float((r.image - image0).abs().max())
    same = torch.equal(r.image, image0)
    log(f"  render of the loaded scene, identity pose: "
        f"{'bit for bit' if same else 'NOT bit for bit'} phase 3's image "
        f"(max abs {err:.3e}); K1 launches {ply_launches['stream_forward']}")
    assert err <= TOL, err
    with torch.no_grad():
      ms = benchmarked("render_ply 2M", lambda g: render_gaussians(
          g, cam, cfg, use_sh=True), (loaded,), iters=5, warmup=1)
    log(f"  render ms by utils.benchmarked (CUDA events, 5 calls after 1): "
        f"{ms:.3f}")

    # (b) Morton order of the 2M positions: card against CPU
    pos = loaded.position
    perm = argsort_morton(pos)
    t0 = time.perf_counter()
    perm_cpu = argsort_morton(pos.cpu())
    t_cpu = time.perf_counter() - t0
    assert torch.equal(perm.cpu(), perm_cpu)
    ms_morton = benchmarked("argsort_morton 2M", argsort_morton, (pos,),
                            iters=10, warmup=1)
    log(f"  argsort_morton of {N_FULL} positions: the card's permutation "
        f"equals the CPU's; card {ms_morton:.3f} ms (CUDA events), CPU "
        f"{t_cpu * 1e3:.1f} ms (host clock, once)")
    del loaded, r, pos, perm, perm_cpu

    # (c) the examples on the card, every K1 and K2 call recorded and held
    # against its twin on the same inputs (render_ply's default 1024x768
    # overflows its capacities); then each example again with --device cpu
    # on the same arguments
    render_argv = [
        ("64x48, 500 splats", [os.path.join(tmp, "small.ply"), "--synthetic",
                               "500", "--image_size", "64,48"]),
        ("1024x768, 100000 splats", [os.path.join(tmp, "default.ply"),
                                     "--synthetic", "100000"])]
    vis_dir = os.path.join(tmp, "vis_split")
    sk.reset_launch_counts()
    t0 = time.perf_counter()
    with recorded_stream_calls() as calls:
      renders = [render_ply.render(render_ply.parse_args(argv))
                 for _, argv in render_argv]
      before, after = vis_split.main(["--out", vis_dir])
      loss, grads = test_backward.main([])
    torch.cuda.synchronize()
    examples_launches = dict(sk.launch_counts)
    t_card = time.perf_counter() - t0
    log(f"  the examples on the card: {t_card:.2f} s; K1 and K2 launches "
        f"{examples_launches['stream_forward']} and "
        f"{examples_launches['stream_backward']}")
    assert examples_launches["stream_forward"] == 5, examples_launches
    assert examples_launches["stream_backward"] == 1, examples_launches
    assert (len(calls["K1"]), len(calls["K2"])) == (5, 1), calls.keys()
    stream_calls_vs_twins(calls, "the examples")

    # the CPU runs: the same mapping (rows, order, windows and drops) and
    # the same overflow; render_ply's image differs by F8 (its projection
    # in f32 on the two devices: near-isotropic axes, depth ranks), so its
    # end-to-end difference is logged, while the 2D examples are held at
    # TOL and their gradients at 1e-4 of each leaf's scale
    t0 = time.perf_counter()
    for (label, argv), got, (m_card, _, _) in zip(render_argv, renders,
                                                  calls["K1"]):
      with recorded_stream_calls() as cpu_calls:
        want = render_ply.render(render_ply.parse_args([*argv, "--device",
                                                        "cpu"]))
      (m_cpu, _, _), = cpu_calls["K1"]
      for f in dataclasses.fields(m_cpu):
        x = getattr(m_cpu, f.name)
        if isinstance(x, torch.Tensor) and not x.is_floating_point():
          assert torch.equal(getattr(m_card, f.name).cpu(), x), (label, f.name)
      diff = (got.image.cpu() - want.image).abs()
      wm = float(got.image_weight.mean())
      log(f"  render_ply {label}: image {tuple(got.image.shape)}, weight "
          f"mean {wm:.4f}, overflow {int(got.num_overflow)}; the CPU run's "
          f"mapping the same but for its float rows (max difference "
          f"{float((m_card.table.cpu() - m_cpu.table).abs().max()):.3e}); "
          f"its image max abs {float(diff.max()):.3e}, "
          f"{int((diff.amax(-1) > TOL).sum())} of "
          f"{diff.shape[0] * diff.shape[1]} pixels beyond TOL")
      assert torch.isfinite(got.image).all() and wm > 0, (label, wm)
    written = sorted(os.listdir(vis_dir))
    assert [os.path.splitext(f)[0] for f in written] == [
        "after_split", "before_split"], written
    cpu_images = vis_split.main(["--out", os.path.join(tmp, "vis_cpu"),
                                 "--device", "cpu"])
    errs = [float((got.cpu() - want).abs().max())
            for got, want in zip((before, after), cpu_images)]
    log(f"  vis_split: {written}, against the CPU run max abs: before "
        f"{errs[0]:.3e}, after {errs[1]:.3e} (tol {TOL:g})")
    assert max(errs) <= TOL, errs
    loss_cpu, grads_cpu = test_backward.main(["--device", "cpu"])
    loss_err = abs(loss - loss_cpu) / abs(loss_cpu)
    grad_errs = {}
    for k, want in grads_cpu.items():
      got = grads[k]
      assert got.is_cuda and torch.isfinite(got).all(), k
      grad_errs[k] = float((got.cpu() - want).abs().max()
                           / max(float(want.abs().max()), 1e-30))
    log(f"  test_backward: loss {loss:.6f}, {loss_err:.3e} relative from the "
        f"CPU run (tol 1e-5); gradients' max abs difference over their "
        f"largest magnitude (tol 1e-4): "
        + ", ".join(f"{k} {v:.3e}" for k, v in grad_errs.items()))
    assert loss_err <= 1e-5, loss_err
    assert max(grad_errs.values()) <= 1e-4, grad_errs
    log(f"  the examples' CPU runs: {time.perf_counter() - t0:.2f} s")
  finally:
    shutil.rmtree(tmp, ignore_errors=True)
  log(f"  phase 12: {time.perf_counter() - t_phase:.1f} s, on {card}")
  return {k: {"ply_launches": ply_launches[k],
              "examples_launches": examples_launches[k]}
          for k in ("stream_forward", "stream_backward")}



# the bench paths of phase 13 that launch K1 and K2
BENCH_PATHS = ("bench", "bench_4k", "bench_stream", "check_card")
# the calibration fields that .bench_cal.json records for each scene
REF_CAL_FIELDS = ("num_slabs", "slab_cap", "w_max", "run_cap", "strip_cap",
                  "big_tile_window", "wide_cap", "dup_cap", "num_wide",
                  "num_dup_rows", "max_tile_rows", "max_strip_rows",
                  "max_run", "max_slab_rows", "overflow")


def cal_beside_reference(label, cal, ref_key):
  """The port's calibration beside the repository's ``.bench_cal.json``
  entry ``ref_key`` (the JAX package's, read as data), field by field.  A
  difference is printed, not failed on.  Returns the differing fields."""
  path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      ".bench_cal.json")
  with open(path) as fh:
    ref = json.load(fh).get(ref_key, {})
  differ = [k for k in REF_CAL_FIELDS if cal.get(k) != ref.get(k)]
  log(f"  {label} calibration, port against .bench_cal.json {ref_key}: " +
      ", ".join(f"{k} {cal.get(k)}" + ("" if k not in differ else
                                        f" [reference {ref.get(k)}]")
                for k in REF_CAL_FIELDS))
  log(f"  {label}: {len(differ)} fields differ: {differ}")
  return differ


def twins_once(m, config, label):
  """K1, then K2 on a seeded cotangent of K1's image (the heuristics and
  visibility columns), each once against its twin on the same inputs: K1
  max abs <= TOL, K2 per column <= 1e-4 * max |twin column| + 1e-6.
  Returns (K1 error, K2 error); each twin runs once, its time logged (host
  clock with synchronisation)."""
  from tpu_splatting_torch.rasterizer import stream_kernels as sk
  hcfg = dataclasses.replace(config, **HEUR)
  img = sk.stream_forward(m, config)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  want = sk.stream_forward_reference(m, config)
  torch.cuda.synchronize()
  t1 = time.perf_counter() - t0
  assert torch.isfinite(img).all(), f"{label}: non-finite K1 output"
  e1 = float((img - want).abs().max())
  del want
  gen = torch.Generator(device=img.device).manual_seed(5)
  gimg = torch.randn(img.shape, generator=gen, device=img.device)
  got = sk.stream_backward(m, img, gimg, hcfg)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  want = sk.stream_backward_reference(m, img, gimg, hcfg)
  torch.cuda.synchronize()
  t2 = time.perf_counter() - t0
  assert torch.isfinite(got).all(), f"{label}: non-finite K2 output"
  err_col = (got - want).abs().amax(0)
  tol_col = 1e-4 * want.abs().amax(0) + 1e-6
  e2 = float(err_col.max())
  log(f"  {label}: K1 max_abs_err {e1:.3e} (tol {TOL:g}), twin {t1:.1f} s; "
      f"K2 ({tuple(got.shape)} buffer) max_abs_err {e2:.3e}, worst column "
      f"at {float((err_col / tol_col).max()):.3f} of its tolerance, twin "
      f"{t2:.1f} s")
  assert e1 <= TOL, f"{label}: K1 disagrees with its twin ({e1})"
  assert bool((err_col <= tol_col).all()), (
      f"{label}: K2 disagrees with its twin", err_col.tolist(),
      tol_col.tolist())
  return e1, e2


def thin_rows_vs_f64(dev):
  """F16 on the card: the bench's heavy scene at 2,000 splats and 128x96
  (``tests/test_torch_bench.py``'s), its scene step on the card (K1, K2)
  against the port's f64 twins on the CPU on the same mapping
  (``benchmarks.thin_splats.heavy_thin_share``).  The gradients of the
  31 splats thinner than 0.1 px within 1e-4 of each column's largest f64
  value.  Returns that largest error, as a share of the column's
  largest."""
  from tpu_splatting_torch.benchmarks import thin_splats
  from tpu_splatting_torch.rasterizer import stream_kernels as sk
  sk.reset_launch_counts()
  share = thin_splats.heavy_thin_share(dev)
  assert sk.launch_counts["stream_backward"] >= 1, sk.launch_counts
  log(f"  F16: heavy 2,000 splats at 128x96, splats thinner than 0.1 px: "
      f"card f32 against the f64 twin, per column "
      f"{[float(f'{x:.3e}') for x in share.tolist()]} of the column's "
      "largest (gate 1e-4)")
  assert float(share.max()) <= 1e-4, share.tolist()
  return float(share.max())


def log_busy(label, fn):
  """fn()'s time by CUDA events over 3 calls beside the device's busy
  time in one call (``device_split``) and its five longest kernels."""
  call = cuda_ms(fn, 3)
  split = device_split(fn, reps=1, attempts=8)
  busy = sum(split.values())
  top = sorted(split.items(), key=lambda kv: -kv[1])[:5]
  log(f"  {label}: {call:.3f} ms by events over 3; device busy "
      f"{busy:.3f} ms ({busy / call:.1%}, idle {1 - busy / call:.1%}) in "
      f"{len(split)} kernels; the longest: " + ", ".join(
          f"{short_kernel_name(k)} {v:.4f}" for k, v in top))


def mapping_summary(m):
  return (f"{m.num_tiles} tiles ({m.tiles_wide}x{m.tiles_high}), "
          f"depth_bits {m.depth_bits}, group width {m.group_width}, "
          f"num_slabs {m.num_slabs}, slab_cap {m.slab_cap}, w_max "
          f"{m.w_max}, run_cap {m.run_cap}, strip_cap {m.strip_cap}, dup_cap "
          f"{m.dup_cap}, table {tuple(m.table.shape)}, overflow "
          f"{m.overflow.tolist()}")


def phase_bench(dev, card):
  """Phase 13: the port's bench (``tpu_splatting_torch.bench`` and its
  companions in ``tpu_splatting_torch.benchmarks``), called as functions.
  Returns {"K1": .., "K2": .., "sorted": ..}: each kernel's launches on
  each bench path (counted from zero around the path) and its largest
  error against its twin there."""
  from tpu_splatting_torch import bench
  from tpu_splatting_torch.benchmarks import (bench_4k, bench_components,
                                              bench_stream, check_card)
  from tpu_splatting_torch.rasterizer import kernels as kk
  from tpu_splatting_torch.rasterizer import layout
  from tpu_splatting_torch.rasterizer import stream_kernels as sk
  from tpu_splatting_torch.utils.benchmarked import benchmarked
  t_phase = time.perf_counter()
  stream_launches, errs = {}, {"K1": [], "K2": []}
  thin_share = thin_rows_vs_f64(dev)

  def keep(e1_e2):                # (K1 error, K2 error) against twins
    errs["K1"].append(e1_e2[0])
    errs["K2"].append(e1_e2[1])

  def stream_counts(label, fn):
    sk.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    stream_launches[label] = {k: sk.launch_counts[k] for k in
                              ("stream_forward", "stream_backward")}
    assert min(stream_launches[label].values()) >= 1, (
        label, stream_launches[label])
    return out

  # (a) the heavy scene at 2M splats: calibration, mapping, twins
  log(f"phase 13 (a): heavy scene, {bench.N} splats {bench.IMAGE_SIZE}, "
      "group width 8")
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  s = bench.prepare_scene("heavy", *bench.to_device(
      dev, *bench.scene_arrays("heavy")), bench.IMAGE_SIZE, 8)
  torch.cuda.synchronize()
  log(f"  calibration and mapping {time.perf_counter() - t0:.1f} s: "
      f"{mapping_summary(s.mapping)}")
  heavy_differ = cal_beside_reference("heavy", s.cal, "heavy_gw8_v7")
  assert s.mapping.overflow.tolist() == [0] * 5, s.mapping.overflow.tolist()
  keep(twins_once(s.mapping, s.config, "heavy 2M"))
  log(f"  peak device memory of (a): "
      f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
  log_busy("heavy map", lambda: s.map_f(*s.map_args))
  del s
  s = bench.prepare_scene("uniform", *bench.to_device(
      dev, *bench.scene_arrays("uniform")), bench.IMAGE_SIZE, 8)
  uniform_differ = cal_beside_reference("uniform", s.cal, "uniform_gw8_v7")
  keep(twins_once(s.mapping, s.config, "uniform 2M"))
  del s
  _, _, full_cal = bench.lift_and_calibrate(
      "uniform", *bench.scene_arrays("uniform"), 8, device=dev)
  full_differ = cal_beside_reference("uniform full", full_cal,
                                     "uniform_full_gw8_v7")

  # (b) bench.py's whole main, its JSON line, the full step's busy share
  log("phase 13 (b): tpu_splatting_torch.bench at its defaults")
  t0 = time.perf_counter()
  out = stream_counts("bench", lambda: bench.run(dev))
  log(f"  bench.run: {time.perf_counter() - t0:.1f} s; K1 and K2 launches "
      f"{stream_launches['bench']}")
  log(json.dumps(out))
  assert "errors" not in out, out["errors"]
  step, g3d, _, _ = bench.prepare_full(
      "uniform", *bench.scene_arrays("uniform"), 8, device=dev)
  with recorded_stream_calls() as calls:
    step(g3d)
  keep(stream_calls_vs_twins(calls, "uniform full step"))
  del calls
  log_busy("the full step", lambda: step(g3d))
  del step, g3d

  # (c) bench_4k: the depth12 key layout at 4096x3072
  log(f"phase 13 (c): bench_4k, {bench_4k.N} splats {bench_4k.IMAGE_SIZE}")
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  s = bench_4k.prepare(dev)
  torch.cuda.synchronize()
  m = s.mapping
  log(f"  calibration and mapping {time.perf_counter() - t0:.1f} s: "
      f"{mapping_summary(m)}")
  assert (m.depth_bits, m.num_tiles, int(m.num_overflow)) == (12, 49152, 0)
  keep(twins_once(m, s.config, "4096x3072 depth12"))
  r4 = stream_counts("bench_4k", lambda: bench_4k.run(s))
  log(f"  4k frame {r4['frame_ms']:.3f} ms: map {r4['map_ms']:.3f}, "
      f"fwd+bwd {r4['raster_ms']:.3f}; K1 and K2 launches "
      f"{stream_launches['bench_4k']}; peak device memory "
      f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
  del s, m

  # (d) bench_components (K4-K7) and bench_stream (K1, K2)
  log("phase 13 (d): bench_components and bench_stream at their defaults")
  kk.reset_launch_counts()
  layout.reset_launch_counts()
  bench_components.bench_projection(device=dev)
  bench_components.bench_sh(device=dev)
  bench_components.bench_tilemapper(device=dev)
  rs = bench_components.rasterizer_setup(device=dev)
  for backward in (False, True):
    benchmarked(f"rasterize {'fwd+bwd' if backward else 'fwd'} n=1000000",
                bench_components.rasterizer_step(rs, backward),
                (rs.packed, rs.feats), iters=5)
  torch.cuda.synchronize()
  sorted_launches = {**kk.launch_counts, **layout.launch_counts}
  log(f"  bench_components launches: {sorted_launches}")
  for k in ("sorted_forward", "sorted_backward", "window_copy",
            "segment_sum_sorted"):
    assert sorted_launches[k] >= 1, (k, sorted_launches)
  m, cfg = rs.mapping, rs.config
  e4 = sorted_forward_vs_twin(m, cfg, "components", 1)[0]
  e5, _, _, gout, _ = sorted_backward_vs_twin(m, cfg, "components", 1)
  e7 = layout_vs_twins(m, gout, "components")
  del rs, m, gout
  ss = bench_stream.setup(device=dev)
  stream_counts("bench_stream", lambda: bench_stream.run(ss, iters=3))
  log(f"  bench_stream K1 and K2 launches {stream_launches['bench_stream']}")
  keep(twins_once(ss.mapping, ss.config, "bench_stream"))
  del ss

  # (e) check_card
  log("phase 13 (e): check_card")
  with recorded_stream_calls() as calls:
    ok = stream_counts("check_card", lambda: check_card.run(dev))
  assert ok, "check_card: a quantity FAILed"
  # its card calls, each against its twin (check_card itself holds the
  # card against the CPU at the reference's looser tolerances)
  keep(stream_calls_vs_twins({k: [c for c in v if c[0].table.is_cuda]
                              for k, v in calls.items()}, "check_card"))
  del calls
  log(f"  phase 13: {time.perf_counter() - t_phase:.1f} s, on {card}; "
      f"calibration fields differing from .bench_cal.json: heavy "
      f"{heavy_differ}, uniform {uniform_differ}, uniform full "
      f"{full_differ}")
  return {"K1": {"bench_launches": {k: v["stream_forward"] for k, v in
                                    stream_launches.items()},
                 "bench_max_abs_err": max(errs["K1"])},
          "K2": {"bench_launches": {k: v["stream_backward"] for k, v in
                                    stream_launches.items()},
                 "bench_max_abs_err": max(errs["K2"]),
                 "thin_rows_vs_f64": thin_share},
          "sorted": {k: {"bench_components_launches": sorted_launches[k],
                         "bench_components_max_abs_err": err}
                     for k, err in (("sorted_forward", e4),
                                    ("sorted_backward", e5),
                                    ("window_copy", 0.0),
                                    ("segment_sum_sorted", e7))}}


# phase 14: the diagnostic scripts, each with its arguments on the card;
# one timed call after one warm-up a label keeps the phase near 90 s
ONE_ITER = ["--iters", "1", "--warmup", "1"]
DIAGNOSTICS = (
    ("profile_map", ["--scene", "heavy", "--gw", "8", *ONE_ITER]),
    ("profile_map2", ["--scene", "heavy", "--gw", "8", *ONE_ITER]),
    ("profile_reduce_map", ONE_ITER),
    ("profile_full", ONE_ITER),
    ("profile_full2", ONE_ITER),
    ("profile_stream", ONE_ITER),
    ("profile_stages", ONE_ITER),
    ("profile_glue", ONE_ITER),
    ("profile_glue2", ONE_ITER),
    ("profile_proj", ONE_ITER),
    ("exp_mapper", ONE_ITER),
    ("exp_reduce", ONE_ITER),
    ("exp_rowgather", ONE_ITER),
    ("exp_layout", ONE_ITER),
    ("exp_precision", ONE_ITER),
)


def heavy_map_split(dev):
  """The heavy 2M map (the bench's scene and cached calibration, group
  width 8) split by ``stream_map`` stage (``profile_map2.stage_split``):
  a split counts once a session gives every stage the kernels an earlier
  one gave (late in the script both may miss a few of the first records:
  ``device_split``'s note); its stages must sum to within 10% of the
  call's device time from a session of its own (``device_split``).
  Returns ({stage: device ms}, the call's device ms)."""
  import argparse
  from tpu_splatting_torch import bench
  from tpu_splatting_torch.benchmarks import diagnostics as dg
  from tpu_splatting_torch.benchmarks import profile_map, profile_map2
  args = argparse.Namespace(n=bench.N, size=bench.IMAGE_SIZE, gw=8)
  s = dg.prepare("heavy", args, dev)
  call = lambda: profile_map.map_call(s, bench.IMAGE_SIZE, s.caps)(
      *s.map_args)
  log_busy("heavy map", call)
  whole = sum(device_split(call, reps=1, attempts=8).values())
  seen = []
  for _ in range(6):
    split = profile_map2.stage_split(call, dev)
    kernels = [(k, st.kernels) for k, st in split.items()]
    if kernels in seen:
      break
    seen.append(kernels)
  else:
    raise AssertionError(f"stage splits never agreed twice: {seen}")
  for line in profile_map2.split_lines(split, whole):
    log(f"  heavy map {line}")
  total = sum(st.ms for st in split.values())
  assert abs(total - whole) <= 0.1 * whole, (total, whole)
  assert list(split) == list(profile_map2.STAGES), list(split)
  return {k: st.ms for k, st in split.items()}, whole


def phase_diagnostics(dev, card):
  """Phase 14: the diagnostic scripts of ``tpu_splatting_torch.benchmarks``
  (``DIAGNOSTICS``), each through its ``main`` with each K1 and K2 call
  recorded and, after the script, held against its twin
  (``stream_calls_vs_twins``); K4-K7 held as phase 13 holds them, on the
  rasterizer setup of ``profile_stages`` and on ``exp_reduce``'s inputs;
  then the heavy map's split by stage.  Returns each kernel's launches by
  script and largest error against its twin there."""
  import importlib
  from tpu_splatting_torch.benchmarks import bench_components, exp_reduce
  from tpu_splatting_torch.rasterizer import function as fn
  from tpu_splatting_torch.rasterizer import kernels as kk
  from tpu_splatting_torch.rasterizer import layout
  from tpu_splatting_torch.rasterizer import stream_kernels as sk
  t_phase = time.perf_counter()
  launches, errs, seconds = {}, {"K1": [0.0], "K2": [0.0]}, {}
  for name, argv in DIAGNOSTICS:
    mod = importlib.import_module(f"tpu_splatting_torch.benchmarks.{name}")
    log(f"phase 14: {name} {' '.join(argv)}")
    for counter in (sk, kk, layout):
      counter.reset_launch_counts()
    t0 = time.perf_counter()
    with recorded_stream_calls(direct=True) as calls:
      assert mod.main(argv) == 0, name
      torch.cuda.synchronize()
    seconds[name] = time.perf_counter() - t0
    launches[name] = {k: v for k, v in {
        **sk.launch_counts, **kk.launch_counts, **layout.launch_counts,
        **layout.probe_launch_counts}.items() if v}
    if calls["K1"] or calls["K2"]:
      e1, e2 = stream_calls_vs_twins(calls, name)
      errs["K1"].append(e1)
      errs["K2"].append(e2)
    del calls
    log(f"  {name}: {seconds[name]:.1f} s, launches {launches[name]}")
  log("phase 14: K4-K7 of profile_stages and K7 of exp_reduce against "
      "their twins")
  rs = bench_components.rasterizer_setup(device=dev)
  e4 = sorted_forward_vs_twin(rs.mapping, rs.config, "profile_stages", 1)[0]
  e5, _, _, gout, _ = sorted_backward_vs_twin(rs.mapping, rs.config,
                                              "profile_stages", 1)
  e7 = layout_vs_twins(rs.mapping, gout, "profile_stages")
  del rs, gout
  g, _, pid = exp_reduce.inputs(4_400_000, 1_000_000, 12, dev)
  e7 = max(e7, segment_sum_checks(g, fn.sort_point_ids(pid), 1_000_000,
                                  "exp_reduce")[0])
  del g, pid
  log("phase 14: the heavy 2M map by stage")
  split, whole = heavy_map_split(dev)
  log(f"  phase 14: {time.perf_counter() - t_phase:.1f} s on {card}; by "
      "script: " + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()))

  def by_script(kernel):
    return {k: v[kernel] for k, v in launches.items() if kernel in v}
  return {"K1": {"diagnostics_launches": by_script("stream_forward"),
                 "diagnostics_max_abs_err": max(errs["K1"])},
          "K2": {"diagnostics_launches": by_script("stream_backward"),
                 "diagnostics_max_abs_err": max(errs["K2"])},
          "sorted": {k: {"diagnostics_launches": by_script(k),
                         "diagnostics_max_abs_err": err}
                     for k, err in (("sorted_forward", e4),
                                    ("sorted_backward", e5),
                                    ("window_copy", 0.0),
                                    ("segment_sum_sorted", e7),
                                    ("row_gather", 0.0))},
          "heavy_map_split_ms": split, "heavy_map_device_ms": whole}


def phase_profiles(dev, card):
  """Phase 15: the profiling modes of K1 and K2 against their twins at
  phase 2's 200k uniform mapping, then ``bench_stream``'s two profiles at
  the reference's 2M scenes.  Returns the K1 and K2 kernels-line fields:
  {kernel: {"ablations": {mode: its error, device span, call time, full
  - mode and what that measures, launches}, "profile_counts",
  "profile_device_ms"}}, K1's also with ``with_counts_launches`` and its
  error."""
  from tpu_splatting_torch import RasterConfig
  from tpu_splatting_torch.benchmarks import bench_stream
  from tpu_splatting_torch.rasterizer import stream_kernels as sk
  from tpu_splatting_torch.scenes import uniform_scene
  t_phase = time.perf_counter()
  log(f"phase 15: the profiling modes vs twins, uniform {N_SMALL} splats "
      f"{SIZE_SMALL}")
  sk.reset_launch_counts()
  scene = uniform_scene(np.random.default_rng(0), N_SMALL, SIZE_SMALL)
  cfg, build, feats, _ = mapped_scene(*scene, SIZE_SMALL, RasterConfig(),
                                      dev)
  m = build(feats)
  fwd, bwd = {}, {}
  for ab in ("", "skeleton", "no_assemble", "no_sort", "no_alpha"):
    want, want_counts = sk.stream_forward_reference(m, cfg, ablate=ab,
                                                    with_counts=True)
    errs, used = [], []
    for with_counts in (False, True) if ab else (True,):
      got = sk.stream_forward(m, cfg, ablate=ab, with_counts=with_counts)
      if with_counts:
        got, counts = got
        assert torch.equal(counts, want_counts), (
            ab, (counts - want_counts).abs().max())
      torch.cuda.synchronize()
      err, share = sk.profile_gate(got, want, "stream_forward", ab)
      errs.append(err)
      used.append(share)
      assert share <= 1.0, (ab, errs, used)
    fwd[ab or "counts"] = {"max_abs_err": max(errs)}
    log(f"  K1 ablate={ab or 'none'}: max_abs_err {max(errs):.3e} with and "
        f"without counts, at {max(used):.3f} of its tolerance "
        f"(sk.profile_gate); counts equal the twin's: iterations "
        f"{int(want_counts[0::8, 0].sum())}, rows "
        f"{int(want_counts[1::8, 0].sum())}, pairs "
        f"{int(want_counts[2::8, 0].sum())}")
  hcfg = dataclasses.replace(cfg, **HEUR)
  img = sk.stream_forward(m, hcfg)
  gimg = torch.randn(img.shape, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(5))
  for ab in ("skeleton", "no_sort", "no_grad", "no_copyback"):
    want = sk.stream_backward_reference(m, img, gimg, hcfg, ablate=ab)
    got = sk.stream_backward(m, img, gimg, hcfg, ablate=ab)
    torch.cuda.synchronize()
    err, used = sk.profile_gate(got, want, "stream_backward", ab)
    assert used <= 1.0, (ab, err, used)
    bwd[ab] = {"max_abs_err": err}
    log(f"  K2 ablate={ab}: max_abs_err {err:.3e}, at {used:.3f} of its "
        "tolerance")
  del m, img, gimg, want, got
  assert sk.launch_counts["stream_forward"] == 1, sk.launch_counts
  assert sk.launch_counts["stream_backward"] == 0, sk.launch_counts
  t_check = time.perf_counter() - t_phase

  profiles = {}
  for backward in (False, True):
    label = "--profile-bwd" if backward else "--profile-fwd"
    log(f"phase 15: bench_stream {label}")
    before = dict(sk.probe_launch_counts)
    s, profiles[label] = bench_stream.run_profile(backward, dev)
    torch.cuda.synchronize()
    log("  launches " + ", ".join(
        f"{k} {v - before[k]}" for k, v in sk.probe_launch_counts.items()
        if v != before[k]))
    if not backward:
      # the card's counts against the twin's, its walked share against the
      # plain footprint model's, on the same mapping
      _, counts = sk.stream_forward(s.mapping, s.config, with_counts=True)
      _, want = sk.stream_forward_reference(s.mapping, s.config,
                                            with_counts=True)
      assert torch.equal(counts, want), float((counts - want).abs().max())
      model = float(stream_walk_mask(s.mapping, s.config).double().mean())
      log(f"  counts equal the twin's; walked share "
          f"{profiles[label]['counts']['walked_share']:.4f} (the card's "
          f"count), {model:.4f} (the plain footprint model)")
      profiles[label]["counts"]["model_walked_share"] = model
    del s
  log(f"  phase 15: {time.perf_counter() - t_phase:.1f} s on {card} (the "
      f"checks at 200k {t_check:.1f} s)")
  out = {}
  for key, table, kernel in (("--profile-fwd", fwd, "stream_forward"),
                             ("--profile-bwd", bwd, "stream_backward")):
    prof = profiles[key]
    for ab, t in prof["modes"].items():
      mode = sk.ABLATION_ALIASES.get(ab, ab)
      if mode:
        table[mode].update(t, launches=sk.probe_launch_counts[
            f"{kernel}_{mode}"])
    out[kernel] = {"ablations": table, "profile_counts": prof["counts"],
                   "profile_device_ms": prof["modes"][""]["device_ms"]}
  counts_err = out["stream_forward"]["ablations"].pop("counts")["max_abs_err"]
  out["stream_forward"].update(
      with_counts_launches=sk.probe_launch_counts["stream_forward_counts"],
      with_counts_max_abs_err=counts_err)
  return out


def main():
  here = os.path.dirname(os.path.abspath(__file__))
  sys.path.insert(0, here)
  card, _ = phase_device()
  dev = torch.device("cuda", 0)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  t_start = time.perf_counter()
  err2, err2b, shard_checks, phase2_out = phase_twin(dev)
  cross_device_check(dev)
  from tpu_splatting_torch.benchmarks import exp_mosaic, exp_pack, exp_pack2
  exp_mosaic.reset_launch_counts()       # the probes lie on no path: 0
  exp_pack.reset_launch_counts()
  exp_pack2.reset_launch_counts()
  k1, k1_floor, g3d, cams, cfg, image0 = phase_full(dev)
  k2, k3 = phase_train(dev, g3d, cams, cfg)
  e4, e5, e7 = phase_sorted_twin(dev)
  sorted_cross_device_check(dev)
  sorted_entries = phase_sorted_full(dev, g3d, cams, cfg)
  t_sharded = time.perf_counter()
  halo, k1_sharded, k2_sharded = phase_sharded(dev, g3d, cams, cfg,
                                               shard_checks, phase2_out)
  del shard_checks, phase2_out
  log(f"phases 2-7: {time.perf_counter() - t_start:.1f} s, phase 7 "
      f"{time.perf_counter() - t_sharded:.1f} s")
  mosaic_entries = phase_mosaic(dev, dict(exp_mosaic.probe_launch_counts))
  pack_entries = phase_pack(dev, dict(exp_pack.probe_launch_counts))
  pack2_entries = phase_pack2(dev, dict(exp_pack2.probe_launch_counts))
  fit = phase_fit(dev, card)
  ply_path = phase_ply(dev, g3d, cams, cfg, image0, card)
  bench_paths = phase_bench(dev, card)
  diag = phase_diagnostics(dev, card)
  prof = phase_profiles(dev, card)
  for e, err in zip(sorted_entries, (e4, e5, 0.0, e7, 0.0, 0.0)):
    e["max_abs_err"] = max(e["max_abs_err"], err)
    on = diag["sorted"].get(e["name"], {})
    if on:
      e.update(on, also_on=list(on["diagnostics_launches"]))
    if e["name"] in bench_paths["sorted"]:
      e.update(bench_paths["sorted"][e["name"]],
               also_on=["bench_components", *e["also_on"]])
  log(f"phase 2 max_abs_err K1 {err2:.3e} K2 {err2b:.3e}; phase 5 K4 "
      f"{e4:.3e} K5 {e5:.3e} K7 {e7:.3e}")
  log(card)                    # name, power limit as nvidia-smi prints them
  src = "tpu_splatting_torch/csrc/"
  ref = "tpu_splatting/rasterizer/stream_kernels.py:"
  log(json.dumps({"kernels": [
      dict(name="stream_forward", route="cuda",
           source=src + "stream_forward.cu", replaces=ref + "412",
           library_ms=None, **k1, **k1_sharded,
           also_on=["band_sharded_forward", "band_sharded_grad",
                    "fit_image_gaussians", "render_ply", "vis_split",
                    "test_backward", *BENCH_PATHS,
                    *diag["K1"]["diagnostics_launches"]],
           fit_image_launches=fit["stream_forward"],
           **ply_path["stream_forward"], **bench_paths["K1"], **diag["K1"],
           **prof["stream_forward"], with_band0=True),
      dict(name="stream_backward", route="cuda",
           source=src + "stream_backward.cu", replaces=ref + "697",
           library_ms=None, **k2, **k2_sharded,
           also_on=["band_sharded_grad", "fit_image_gaussians",
                    "test_backward", *BENCH_PATHS,
                    *diag["K2"]["diagnostics_launches"]],
           fit_image_launches=fit["stream_backward"],
           **ply_path["stream_backward"], **bench_paths["K2"], **diag["K2"],
           **prof["stream_backward"], with_band0=True, with_halo=True),
      dict(name="merge_grad_slabs", route="cuda",
           source=src + "stream_backward.cu", replaces=ref + "996",
           fused_into="stream_backward", **k3),
      dict(name="halo_merge", route="cuda",
           source=src + "stream_backward.cu", replaces=ref + "996",
           mode_of="merge_grad_slabs (halo=True)", path="band_sharded_grad",
           **halo),
      *sorted_entries,
      dict(name="stream_forward_floor", route="cuda",
           source=src + "stream_forward.cu", replaces=ref + "412",
           probe_of="stream_forward", **k1_floor),
      *mosaic_entries, *pack_entries, *pack2_entries]}))
  log(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
  main()
