"""Card-vs-CPU check of the stream pipeline: the counterpart of
``benchmarks/check_tpu.py``.

    python -m tpu_splatting_torch.benchmarks.check_card [--group-width 2]

Renders a small scene through ``stream_map`` and the stream forward and
backward (``stream_rasterize_with_mapping`` with visibility and the point
heuristics) twice: once on the card (the kernels K1 and K2) and once on
the CPU (their plain twins, held against the reference elsewhere: the
``tests/test_torch_stream_*.py`` files).  It compares the mappings field
by field (exactly: the same integer fields and the same table) and the
loss, images and gradients row by row, printing one PASS / FAIL line per
quantity with error quantiles, and exits 1 on any FAIL.

Two scenes, the reference's: ``make_scene`` (12,000 splats at 256x192
with culled, below-threshold and wide splats, distinct depth keys) and
``make_deep_scene`` (one tile ~900 rows deep, in one slab of 1280 rows).
The tolerances are the reference's.  Card and CPU round ``exp`` an ulp
apart, so an alpha at the threshold may flip a pixel's term (ROADMAP F7).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import bench
from ..data_types import RasterConfig
from ..rasterizer.stream import StreamMapping, stream_map
from ..rasterizer.stream_function import (probe_width,
                                          stream_rasterize_with_mapping)

# every StreamMapping tensor a mapper on two devices must build equal
MAPPING_FIELDS = ("table", "pid_order", "desc", "strip_blk", "run_starts",
                  "overflow", "grad_src", "dup_src", "dup_pid")


def make_scene(n, image_size, seed=0, n_culled=64, n_dim=64, n_wide=32):
  """The reference's scene: n splats, the first n_culled behind the camera,
  the next n_dim below the alpha threshold, the last n_wide wide (sigma
  10-25 px: duplicate rows), distinct depth14 keys."""
  rng = np.random.default_rng(seed)
  w, h = image_size
  packed = np.zeros((n, 7), np.float32)
  packed[:, 0] = rng.uniform(0, w, n)
  packed[:, 1] = rng.uniform(0, h, n)
  th = rng.uniform(0, np.pi, n)
  packed[:, 2] = np.cos(th)
  packed[:, 3] = np.sin(th)
  packed[:, 4:6] = (rng.random((n, 2)) + 0.2) * 2.5
  packed[:, 6] = rng.uniform(0.1, 0.9, n)
  packed[-n_wide:, 4:6] = rng.uniform(10.0, 25.0, (n_wide, 2))
  if n * 4 >= (1 << 16):
    raise ValueError(f"{n} splats: distinct depth14 keys need n < 16384")
  depth = ((rng.permutation(n).astype(np.float32) + 0.5) / n).astype(
      np.float32)
  depth[:n_culled] = -1.0
  packed[n_culled:n_culled + n_dim, 6] = 1e-4
  feats = rng.random((n, 3)).astype(np.float32)
  return packed, depth, feats


def make_deep_scene(n, image_size, seed=3):
  """The reference's deep-tile scene: ~900 rows in tile (1, 1)."""
  rng = np.random.default_rng(seed)
  w, h = image_size
  packed = np.zeros((n, 7), np.float32)
  packed[:, 0] = rng.uniform(0, w, n)
  packed[:, 1] = rng.uniform(0, h, n)
  n_deep = 900
  packed[:n_deep, 0] = rng.uniform(18.0, 30.0, n_deep)
  packed[:n_deep, 1] = rng.uniform(18.0, 30.0, n_deep)
  th = rng.uniform(0, np.pi, n)
  packed[:, 2] = np.cos(th)
  packed[:, 3] = np.sin(th)
  packed[:, 4:6] = (rng.random((n, 2)) + 0.3) * 1.2
  packed[:, 6] = rng.uniform(0.1, 0.4, n)
  if n * 4 >= (1 << 16):
    raise ValueError(f"{n} splats: distinct depth14 keys need n < 16384")
  depth = ((rng.permutation(n).astype(np.float32) + 0.5) / n).astype(
      np.float32)
  feats = rng.random((n, 3)).astype(np.float32)
  return packed, depth, feats


def mapping_differences(a: StreamMapping, b: StreamMapping) -> list:
  """The names of ``MAPPING_FIELDS`` whose tensors differ (any device)."""
  return [name for name in MAPPING_FIELDS
          if not torch.equal(getattr(a, name).cpu(), getattr(b, name).cpu())]


def run_on(device, packed, depth, feats, image_size, config, caps, gw):
  """The mapping and {loss, image, weight, g_points, g_feats, g_probe} as
  numpy arrays, on one device."""
  p, d, f = bench.to_device(torch.device(device), packed, depth, feats)
  m = stream_map(p, d, f, image_size, config, group_width=gw, **caps)
  p.requires_grad_(True)
  f.requires_grad_(True)
  probe = torch.zeros((p.shape[0], probe_width(config)), device=p.device,
                      requires_grad=True)
  img, wgt = stream_rasterize_with_mapping(p, f, m, image_size, config,
                                           probe=probe)
  loss = ((img - 0.5) ** 2).sum() + (wgt ** 2).sum()
  grads = torch.autograd.grad(loss, (p, f, probe))
  out = dict(loss=loss, image=img, weight=wgt, g_points=grads[0],
             g_feats=grads[1], g_probe=grads[2])
  return m, {k: v.detach().cpu().numpy() for k, v in out.items()}


def compare(name, a, b, rtol, atol) -> bool:
  """PASS where |a - b| <= atol + rtol |b| everywhere; prints the largest
  error and the relative error's quantiles."""
  err = np.abs(a - b)
  scale = np.maximum(np.abs(b), atol / max(rtol, 1e-30))
  rel = err / scale
  ok = bool((err <= atol + rtol * np.abs(b)).all())
  print(f"{'PASS' if ok else 'FAIL'} {name}: max_abs={err.max():.3e} "
        f"rel_p50={np.quantile(rel, 0.5):.2e} "
        f"rel_p99={np.quantile(rel, 0.99):.2e} rel_max={rel.max():.3e}",
        flush=True)
  return ok


def check(tag, packed, depth, feats, image_size, config, caps, gw, card,
          n_zero_grad=0) -> bool:
  """One scene on the card against the CPU twins; True if all PASS."""
  m_ref, ref = run_on("cpu", packed, depth, feats, image_size, config, caps,
                      gw)
  m_got, got = run_on(card, packed, depth, feats, image_size, config, caps,
                      gw)
  overflow = (int(m_ref.num_overflow), int(m_got.num_overflow))
  print(f"[{tag}] overflow cpu={overflow[0]} card={overflow[1]}", flush=True)
  if overflow[0] != 0:
    raise RuntimeError(f"{tag}: the scene overflows its capacities "
                       f"{m_ref.overflow.tolist()}: invalid")
  differ = mapping_differences(m_got, m_ref)
  print(f"{'FAIL' if differ else 'PASS'} {tag} mapping identical on card "
        f"and CPU" + (f": {differ} differ" if differ else ""), flush=True)
  ok = not differ
  ok &= compare(f"{tag} loss", got["loss"], ref["loss"], 5e-3, 1e-3)
  ok &= compare(f"{tag} image", got["image"], ref["image"], 2e-2, 2e-3)
  ok &= compare(f"{tag} weight", got["weight"], ref["weight"], 2e-2, 2e-3)
  for key, label in (("g_points", "g_points"), ("g_feats", "g_feats"),
                     ("g_probe", "g_probe (vis/heur)")):
    ok &= compare(f"{tag} {label}", got[key], ref[key], 5e-2,
                  2e-2 * np.abs(ref[key]).max())
  if n_zero_grad:
    culled = np.abs(got["g_points"][:n_zero_grad]).max()
    print(f"{'PASS' if culled == 0 else 'FAIL'} {tag} culled rows zero-grad "
          f"(max={culled:.3e})", flush=True)
    ok &= bool(culled == 0)
  return ok


def run(card, gw: int = 2) -> bool:
  """Both scenes; True if every quantity passes."""
  config = RasterConfig(compute_point_heuristic=True, compute_visibility=True)
  image_size = (256, 192)
  caps = dict(num_slabs=6, strip_cap=2048, slab_cap=512, w_max=40,
              run_cap=512, wide_cap=256, dup_cap=16384)
  ok = check("main", *make_scene(12_000, image_size), image_size, config,
             caps, gw, card, n_zero_grad=128)
  # one tile deeper than the largest tiered copy: chunked windows
  deep_size = (256, 48)      # 16 tiles wide: every group width divides it
  deep_caps = dict(num_slabs=1, strip_cap=1024, slab_cap=1280, w_max=16,
                   run_cap=1024, wide_cap=0, dup_cap=0)
  ok &= check("deep", *make_deep_scene(3_000, deep_size), deep_size,
              config, deep_caps, gw, card)
  print("ALL PASS" if ok else "FAILURES: see above", flush=True)
  return ok


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--group-width", type=int, default=2)
  args = parser.parse_args(argv)
  card = bench.device_of("cuda")
  print(bench.card_line(card), flush=True)
  return 0 if run(card, args.group_width) else 1


if __name__ == "__main__":
  sys.exit(main())
