#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. Device and build: needs CUDA, prints the card's name and power limit,
   builds the stream forward kernel (K1) from ``tpu_splatting_torch/csrc``.
2. Kernel against its plain twin on the card: 200k splats at 1024x768
   (``bench.uniform_scene``; blending, antialias and quantile modes) and
   200k splats with ``bench.heavy_scene`` statistics (calibrated from
   slab_cap 1024 and from 128: many slabs), each mapped by the
   port's own ``calibrate_stream`` + ``stream_map``; plus one small 3D
   scene mapped on the card and on the CPU (identical mapping) and
   composited by the kernel and by the twin on the CPU.
3. The forward render at full size: 2M splats at 2048x1536, SH degree 3
   (``bench.uniform_scene`` lifted to 3D), five ``render_gaussians``
   requests under ``torch.no_grad()`` (the last with the median-depth
   pass), checked for zero overflow, finite images and weights in [0, 1],
   with the K1 launch count of that run; then a staged timing of one
   render, and K1 against its twin at the full-size shapes.

The last two lines of standard output are one JSON object with the
kernels' launches, errors and times, and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
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
                                                    load_kernel_library)
  load_kernel_library("stream_forward.cu")
  info = build_info["stream_forward.cu"]
  log(f"K1 build: {info['seconds']:.2f} s")
  for line in info["log"].splitlines():
    if "registers" in line or "spill" in line:
      log(f"  ptxas: {line.strip()}")
  return card


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
  from bench import heavy_scene, uniform_scene
  from tpu_splatting_torch import RasterConfig
  errs = []
  log(f"phase 2: K1 vs twin, uniform {N_SMALL} splats {SIZE_SMALL}")
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

  # heavy statistics twice: slab_cap > 512, and many thin slabs (the
  # carry across slabs); both with wide-splat duplication
  scene = heavy_scene(np.random.default_rng(1), N_SMALL, SIZE_SMALL)
  for slab_cap in (1024, 128):
    log(f"phase 2: K1 vs twin, heavy statistics {N_SMALL} splats, "
        f"calibrated from slab_cap {slab_cap}")
    cfg, build, feats, _ = mapped_scene(*scene, SIZE_SMALL, RasterConfig(),
                                        dev, slab_cap=slab_cap)
    m = build(feats)
    log(f"  heavy mapping: slab_cap {m.slab_cap} num_slabs {m.num_slabs} "
        f"w_max {m.w_max} dup_cap {m.dup_cap}")
    errs.append(kernel_vs_twin(m, cfg, "heavy blending", reps=1)[0])
  return max(errs)


def cross_device_check(dev):
  """A small 3D scene rendered on the card, and its projected splats
  mapped and composited on the CPU: the mapper's integer fields and table
  must be identical; the images agree to TOL except where an a_raw lies
  within an ulp of alpha_threshold (CPU and CUDA exp differ by an ulp),
  which moves a pixel by at most alpha_threshold."""
  from bench import uniform_scene
  from tpu_splatting_torch import RasterConfig, render_gaussians
  from tpu_splatting_torch.perspective.projection import (ndc_depth,
                                                          project_to_image)
  from tpu_splatting_torch.rasterizer.stream_function import (
      stream_map_with_config)
  from tpu_splatting_torch.renderer import render_projected
  from tpu_splatting_torch.scenes import lift_to_3d
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
  from bench import uniform_scene
  from tpu_splatting_torch import RasterConfig, calibrate_stream
  from tpu_splatting_torch.perspective.projection import (ndc_depth,
                                                          project_to_image)
  from tpu_splatting_torch.rasterizer import stream_kernels as sk
  from tpu_splatting_torch.rasterizer.stream_function import (
      detile, stream_map_with_config)
  from tpu_splatting_torch.renderer import render_gaussians
  from tpu_splatting_torch.scenes import lift_to_3d
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

  # staged timing of one render (same public functions, CUDA events)
  cam = cams[0]
  with torch.no_grad():
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    for _ in range(2):                        # warm once, time the second
      ev[0].record()
      g2d, depths, _ = project_to_image(g3d, cam, cfg)
      ev[1].record()
      feats = evaluate_sh_at(g3d.feature, g3d.position, cam.camera_position)
      ev[2].record()
      nd = torch.where(depths > 0,
                       ndc_depth(depths, cam.near_plane, cam.far_plane), 0.0)
      m = stream_map_with_config(g2d, nd, feats, SIZE_FULL, cfg)
      ev[3].record()
      it = sk.stream_forward(m, cfg)
      ev[4].record()
      detile(it, m.tiles_wide, m.tiles_high, cfg.tile_size, SIZE_FULL)
      ev[5].record()
      torch.cuda.synchronize()
    names = ("project", "SH", "map", "K1", "detile")
    stages = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}
    log("  stages (ms): " + "  ".join(f"{n} {t:.3f}"
                                      for n, t in stages.items()))

    log("  K1 vs twin at the full-size shapes")
    err_b, k_ms, t_ms = kernel_vs_twin(m, cfg, "full blending", reps=5)
    median_cfg = dataclasses.replace(cfg, use_alpha_blending=False,
                                     saturate_threshold=cfg.median_threshold)
    mq = stream_map_with_config(
        g2d, nd, torch.cat([feats, depths], -1), SIZE_FULL, cfg)
    err_q, _, _ = kernel_vs_twin(mq, median_cfg, "full quantile", reps=1)
  return {"launches": launches, "max_abs_err": max(err_b, err_q),
          "ms": k_ms, "plain_ms": t_ms}


def main():
  here = os.path.dirname(os.path.abspath(__file__))
  sys.path.insert(0, here)
  card = phase_device()
  dev = torch.device("cuda", 0)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  err2 = phase_twin(dev)
  cross_device_check(dev)
  k1 = phase_full(dev)
  log(f"phase 2 max_abs_err {err2:.3e}")
  log(card)                    # name, power limit as nvidia-smi prints them
  log(json.dumps({"kernels": [{
      "name": "stream_forward",
      "route": "cuda",
      "source": "tpu_splatting_torch/csrc/stream_forward.cu",
      "replaces": "tpu_splatting/rasterizer/stream_kernels.py:412",
      "launches": k1["launches"],
      "max_abs_err": k1["max_abs_err"],
      "ms": k1["ms"],
      "plain_ms": k1["plain_ms"]}]}))
  log(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
  main()
