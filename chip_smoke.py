#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. Device and build: needs CUDA, prints the card's name and power limit,
   builds every kernel from ``tpu_splatting_torch/csrc`` (one ``nvcc``
   per source, all in parallel: the stream forward K1 and backward K2,
   the sorted forward K4 and backward K5, the layout kernels K6 and K7)
   and prints each kernel instantiation's registers and spills (K2's and
   K5's as <most features, reduction width V>; the generic
   instantiations, which take any feature count and tile, as
   *_generic_kernel).  Then, for every kernel at the headline shapes, the
   instantiation, threads and shared memory the wrapper's plan picks and
   the resident blocks and warps per SM
   (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); and the plans'
   shared-memory formulas (Python) against the kernels' own ``*_smem``
   entries (C) over a grid of feature counts, tiles and capacities.
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
   synchronisations), and K1 against its twin at the full-size shapes.
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
   + 1e-6), K6 bit for bit, K7 per column <= 1e-5 * max + 1e-6; K4 and
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
   render and per step; staged timings of a render and a step; K4-K7
   against their twins and K6 / K7 against one PyTorch call at the
   full-size shapes, where K6, K7, torch indexing and ``index_add_`` are
   each timed as calls (CUDA events over 5 back-to-back calls) and by
   device time (the kernels' own time under ``torch.profiler`` over 20
   calls, so that a kernel of tens of microseconds is not judged by its
   Python wrapper); and, for information, the sorted image against the
   stream image of the same pose (the stream pipeline composites in 14-bit
   depth order, the sorted one in exact f32 depth order).

The last two lines of standard output are one JSON object with the
kernels' launches, errors, times, bounds and resident warps per SM at the
full shapes (K6 and K7 with ``device_ms`` and ``library_device_ms`` too,
K5 with its run-to-run difference), and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

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
# weight sum 1, log1p + add 2.  K2 adds to that the gradient chain: g.f
# 2F+1, remaining sum 4, alpha_grad 4, z0 2, u, v and their products 12,
# the six geometry gradients 24, features F, prune 1, split 3, and the
# pixel reduction of the slabw columns.
K1_OPS_PER_PAIR = 18 + 2 * 3


def k2_ops_per_pair(slabw):
  return K1_OPS_PER_PAIR + (2 * 3 + 1) + 4 + 4 + 2 + 12 + 24 + 3 + 4 + slabw


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


def device_ms(fn, reps=20):
  """Device time of one fn() call, in ms, without the host's work around
  its launches (argument checks, the Python wrapper, the launch itself),
  which cuda_ms's events over back-to-back calls include wherever the
  device waits for the host: the CUDA kernels' own time under
  torch.profiler, summed over reps calls and divided by reps."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    for _ in range(reps):
      fn()
    torch.cuda.synchronize()
  us = sum(e.device_time_total for e in prof.events()
           if e.device_type == DeviceType.CUDA)
  assert us > 0, "torch.profiler recorded no device time"
  return us / reps / 1e3


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
           "K6, K7": "layout.cu"}
# f32 operations per (row, pixel) pair of the sorted forward (K4): K1's
# count plus the visibility sum; K5: K2's count for its 7 + F + 2 columns
K4_OPS_PER_PAIR = K1_OPS_PER_PAIR + 1


def entry_label(ptxas_line):
  """'stream_backward_kernel<6, 16>' from ptxas's mangled name in its
  'Compiling entry function' line."""
  m = re.search(r"\d([A-Za-z_]+_kernel)I(.+?)EEv", ptxas_line)
  if m is None:
    return ptxas_line.strip()
  args = re.findall(r"Li(\d+)E", m.group(2)) or [
      {"j": "uint32", "m": "uint64", "f": "float", "d": "double"}.get(
          m.group(2), m.group(2))]
  return f"{m.group(1)}<{', '.join(args)}>"


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


def occupancy_of(name, plan=None):
  """Resident blocks and warps per SM, registers and local bytes of a
  kernel: K1, K2, K4, K5 at a plan, K6 / K7 as they launch (f32 rows,
  256 threads, no shared memory)."""
  import ctypes
  from tpu_splatting_torch.rasterizer import layout
  from tpu_splatting_torch.utils.cuda_build import occupancy
  if name in ("K6", "K7"):
    out = (ctypes.c_int * 3)()
    err = layout._kernel().tpu_splat_layout_occupancy(
        0 if name == "K6" else 1, 4, 256, out)
    assert err == 0, err
    return {"blocks_per_sm": out[0], "warps_per_sm": out[0] * 8,
            "registers": out[1], "local_bytes": out[2]}
  lib, stem, plan0, _ = kernel_plans(**HEADLINE)[name]
  return occupancy(lib, stem, plan or plan0)


def phase_plans():
  """Occupancy of every kernel at the headline shapes, and the plans'
  shared-memory formulas against the C entries'."""
  occ = {}
  for name in ("K1", "K2", "K4", "K5", "K6", "K7"):
    occ[name] = occupancy_of(name)
    plan = (kernel_plans(**HEADLINE)[name][2] if name not in ("K6", "K7")
            else None)
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


def phase_twin(dev):
  """Phases 2 and 2b: (K1 max error, K2 max error)."""
  from tpu_splatting_torch import RasterConfig
  from tpu_splatting_torch.scenes import heavy_scene, uniform_scene
  errs, errs2 = [], []
  log(f"phase 2: K1 and K2 vs twins, uniform {N_SMALL} splats {SIZE_SMALL}")
  scene = uniform_scene(np.random.default_rng(0), N_SMALL, SIZE_SMALL)
  cfg, build, feats, depth = mapped_scene(*scene, SIZE_SMALL,
                                          RasterConfig(), dev)
  m = build(feats)
  errs.append(kernel_vs_twin(m, cfg, "blending")[0])
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
    log(f"  heavy mapping: slab_cap {m.slab_cap} num_slabs {m.num_slabs} "
        f"w_max {m.w_max} dup_cap {m.dup_cap}")
    errs.append(kernel_vs_twin(m, cfg, "heavy blending", reps=1)[0])
    errs2.append(backward_vs_twin(
        m, dataclasses.replace(cfg, **HEUR), "heavy heuristics", reps=1)[0])

  # the heavy scene's calibration at 2M splats asks for slab_cap 1792:
  # K2 must still fit one block's shared memory there at F = 3 with
  # heuristics (13 columns; w_max as in the 32-slab mapping above)
  from tpu_splatting_torch.rasterizer import stream_kernels as sk
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
  return max(errs), max(errs2)


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
  for name in ("table", "pid_order", "desc", "strip_blk", "run_starts",
               "overflow", "grad_src", "dup_src", "dup_pid"):
    a, b = getattr(maps[0], name).cpu(), getattr(maps[1], name)
    assert torch.equal(a, b), f"mapper differs between card and CPU: {name}"
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


def phase_full(dev):
  from tpu_splatting_torch import RasterConfig, calibrate_stream
  from tpu_splatting_torch.perspective.projection import (ndc_depth,
                                                          project_to_image)
  from tpu_splatting_torch.rasterizer import stream_kernels as sk
  from tpu_splatting_torch.rasterizer.stream_function import (
      detile, stream_map_with_config)
  from tpu_splatting_torch.renderer import render_gaussians
  from tpu_splatting_torch.scenes import lift_to_3d, uniform_scene
  from tpu_splatting_torch.spherical_harmonics import evaluate_sh_at

  log(f"phase 3: {N_FULL} splats {SIZE_FULL} SH degree 3")
  packed, depth, feats = uniform_scene(np.random.default_rng(0), N_FULL,
                                       SIZE_FULL)
  g3d, cam0 = lift_to_3d(packed, depth, feats, SIZE_FULL, near=0.1,
                         far=100.0, fov_deg=70.0, device=dev)
  del packed, depth, feats
  cams = [cam0.replace(T_camera_world=t) for t in poses(dev)]
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
      if median:
        assert torch.isfinite(r.median_depth_image).all()
      log(f"  request {i}: {times[-1]:.2f} ms  weight in [{w_min:.4f}, "
          f"{w_max:.6f}]  mean rgb {r.image.mean().item():.4f}"
          + ("  (+median pass)" if median else ""))
  launches = sk.launch_counts["stream_forward"]
  peak = torch.cuda.max_memory_allocated() / 2 ** 30
  log(f"  K1 launches in the 5 requests: {launches}")
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
  return k1, g3d, cams, cfg


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


def layout_vs_twins(m, gout, label, reps=3):
  """K6 bit for bit on the overlap ids and the sorted rows; K7 on the
  gradient rows sorted by point id, per column <= 1e-5 * max + 1e-6.
  Returns (K7 max abs error, timings dict)."""
  from tpu_splatting_torch.rasterizer import layout
  from tpu_splatting_torch.rasterizer.function import _pid_chunked
  g = m.chunk_size
  for rows in (m.overlap_to_point, m.sorted_payload):
    got = layout.window_copy(rows, m.chunk_src, m.chunk_cnt, g)
    want = layout.window_copy_reference(rows, m.chunk_src, m.chunk_cnt, g)
    assert torch.equal(got, want), f"{label}: K6 differs from its twin"
  ids, order = torch.sort(_pid_chunked(m), stable=True)
  rows = gout[order]
  got = layout.segment_sum_sorted(rows, ids, m.num_points)
  want = layout.segment_sum_sorted_reference(rows, ids, m.num_points)
  torch.cuda.synchronize()
  err_col = (got - want).abs().amax(0)
  tol_col = 1e-5 * want.abs().amax(0) + 1e-6
  err = float(err_col.max())
  log(f"  {label} K6: bit-exact on ids and rows; K7: max_abs_err "
      f"{err:.3e}, worst column at "
      f"{float((err_col / tol_col).max()):.3f} of its tolerance")
  assert bool((err_col <= tol_col).all()), (
      f"{label}: K7 disagrees with its twin", err_col.tolist())
  return err


def phase_sorted_twin(dev):
  """Phase 5: (K4, K5, K7 max errors) at the check shapes."""
  from tpu_splatting_torch import RasterConfig
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


def phase_sorted_full(dev, g3d, cams, stream_cfg):
  """Phase 6: the sorted pipeline at full size.  Returns the K4-K7
  entries of the kernels line (without the phase-5 errors)."""
  from tpu_splatting_torch import (RasterConfig, map_to_tiles,
                                   render_gaussians, render_with_heuristics)
  from tpu_splatting_torch.mapper.tile_mapper import (calibrate_mapper,
                                                      tile_shape)
  from tpu_splatting_torch.optim import GroupConfig, VisibilityAwareAdam
  from tpu_splatting_torch.perspective.projection import (ndc_depth,
                                                          project_to_image)
  from tpu_splatting_torch.rasterizer import function as fn
  from tpu_splatting_torch.rasterizer import kernels as kk
  from tpu_splatting_torch.rasterizer import layout
  from tpu_splatting_torch.rasterizer.stream_function import detile
  from tpu_splatting_torch.spherical_harmonics import evaluate_sh_at

  log(f"phase 6: sorted pipeline, {N_FULL} splats {SIZE_FULL} SH degree 3")
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
  cap = caps["max_overlaps"]

  def counts():
    return {**kk.launch_counts, **layout.launch_counts}

  # three requests through the public entry point
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  kk.reset_launch_counts()
  layout.reset_launch_counts()
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
    pid = fn._pid_chunked(m)
    vis = fn.reduce_chunked_to_points(vis_c, pid, n)[:, 0]
    st.mark()
    it_g = it.detach().requires_grad_(True)
    full = detile(it_g[:t_all], tw, th, ts, SIZE_FULL)
    (g_it,) = torch.autograd.grad(((full[..., :3] - tgt) ** 2).sum(), it_g)
    st.mark()
    gout = kk.backward(m.sorted_payload, it, g_it, m.chunk_src, m.chunk_cnt,
                       m.chunk_to_tile, tcfg, t_all, tw)
    st.mark()
    red = fn.reduce_chunked_to_points(gout, fn._pid_chunked(m), n)
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
  plans = kernel_plans(f, tcfg.tile_area, 512, 27, g)
  occ4 = occupancy_of("K4", plans["K4"][2])
  occ5 = occupancy_of("K5", plans["K5"][2])
  log(f"  K4 {occ4}, K5 {occ5} at the full shapes")

  # K6 and K7 take tens of microseconds: each is timed twice, as calls
  # (events over back-to-back calls, the wrapper's host work included
  # where the device waits for it) and by device time (device_ms)
  o2p, src, cnt = m.overlap_to_point, m.chunk_src, m.chunk_cnt
  k6_ms = cuda_ms(lambda: layout.window_copy(o2p, src, cnt, g), 5)
  k6_dev = device_ms(lambda: layout.window_copy(o2p, src, cnt, g))
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

  ids, order = torch.sort(fn._pid_chunked(m), stable=True)
  rows = gout[order]
  k7_ms = cuda_ms(lambda: layout.segment_sum_sorted(rows, ids, n), 5)
  k7_dev = device_ms(lambda: layout.segment_sum_sorted(rows, ids, n))
  t7_ms = cuda_ms(lambda: layout.segment_sum_sorted_reference(rows, ids, n),
                  5)
  acc = torch.zeros((n + 1, out_w), device=dev)
  ids_c = torch.clamp(ids, max=n)
  l7_ms = cuda_ms(lambda: acc.index_add_(0, ids_c, rows), 5)
  l7_dev = device_ms(lambda: acc.index_add_(0, ids_c, rows))
  b7 = bound_ms(0, nbytes(rows, ids) + (n + 1) * 4 + n * out_w * 4)
  log(f"  K7 ({rows.shape[0]} rows x {out_w} columns -> {n} points): kernel "
      f"{k7_ms:.4f} ms a call, {k7_dev:.4f} ms of device time (its "
      f"searchsorted included); index_add_ {l7_ms:.4f} ms a call, "
      f"{l7_dev:.4f} ms of device time; twin {t7_ms:.3f} ms; bound "
      f"{b7[0]:.4f} ms ({b7[1]})")

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
  ]


def main():
  here = os.path.dirname(os.path.abspath(__file__))
  sys.path.insert(0, here)
  card, _ = phase_device()
  dev = torch.device("cuda", 0)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  err2, err2b = phase_twin(dev)
  cross_device_check(dev)
  k1, g3d, cams, cfg = phase_full(dev)
  k2, k3 = phase_train(dev, g3d, cams, cfg)
  e4, e5, e7 = phase_sorted_twin(dev)
  sorted_cross_device_check(dev)
  sorted_entries = phase_sorted_full(dev, g3d, cams, cfg)
  for e, err in zip(sorted_entries, (e4, e5, 0.0, e7)):
    e["max_abs_err"] = max(e["max_abs_err"], err)
  log(f"phase 2 max_abs_err K1 {err2:.3e} K2 {err2b:.3e}; phase 5 K4 "
      f"{e4:.3e} K5 {e5:.3e} K7 {e7:.3e}")
  log(card)                    # name, power limit as nvidia-smi prints them
  src = "tpu_splatting_torch/csrc/"
  ref = "tpu_splatting/rasterizer/stream_kernels.py:"
  log(json.dumps({"kernels": [
      dict(name="stream_forward", route="cuda",
           source=src + "stream_forward.cu", replaces=ref + "412",
           library_ms=None, **k1),
      dict(name="stream_backward", route="cuda",
           source=src + "stream_backward.cu", replaces=ref + "697",
           library_ms=None, **k2),
      dict(name="merge_grad_slabs", route="cuda",
           source=src + "stream_backward.cu", replaces=ref + "996",
           fused_into="stream_backward", **k3),
      *sorted_entries]}))
  log(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
  main()
