"""Kernel times of two checkouts of the repository on one card, in turns.

    python -m tpu_splatting_torch.benchmarks.turns --other DIR

runs this file's ``--measure`` once in the checkout DIR (an unpacked
parent commit, say), twice in this one and once more in DIR, each in a
process of its own on the same card, and prints each time beside its
counterpart.  ``--measure`` times, in the checkout it runs in (its
``tpu_splatting_torch`` and ``chip_smoke.py``):

* K2 (``stream_backward``) at the headline training step: 2M splats at
  2048x1536, SH 3, heuristics and visibility, the identity pose's own
  calibration (``chip_smoke.py`` phase 4 takes the largest over five
  poses); events over 5 calls and device time;
* T2 (``reshape_rows``) against the copy of the reshaped view and T4
  (``dma_residue_sum``, bulk and per-thread copies) at phase 8's inputs,
  in turns, device time from a flushed L2.

Each process prints the card's name and power limit and one JSON line;
the first process then prints the readings beside each other.  Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import torch

KEYS = ("K2", "T2", "clone", "T4 bulk", "T4 loads")


def measure() -> dict:
  """{key: (ms a call by events, device ms)} in this checkout."""
  import chip_smoke as c
  from tpu_splatting_torch import RasterConfig, calibrate_stream
  from tpu_splatting_torch.benchmarks import exp_mosaic as em
  from tpu_splatting_torch.mapper.tile_mapper import tile_shape
  from tpu_splatting_torch.perspective.projection import (ndc_depth,
                                                          project_to_image)
  from tpu_splatting_torch.rasterizer import stream_kernels as sk
  from tpu_splatting_torch.rasterizer.stream_function import (
      entile, stream_map_with_config, stream_rasterize_with_mapping,
      tile_mask)
  from tpu_splatting_torch.spherical_harmonics import evaluate_sh_at

  dev = torch.device("cuda", 0)
  out = {}
  g3d, cams = c.headline_scene(dev)
  cam = cams[0]
  base = RasterConfig(stream_group_width=8)
  with torch.no_grad():
    g2d, depths, _ = project_to_image(g3d, cam, base)
    nd = torch.where(depths > 0,
                     ndc_depth(depths, cam.near_plane, cam.far_plane), 0.0)
    feats = evaluate_sh_at(g3d.feature, g3d.position, cam.camera_position)
    cal = calibrate_stream(g2d, nd, feats, c.SIZE_FULL, base, group_width=8)
  cfg = dataclasses.replace(
      base, stream_num_slabs=cal["num_slabs"],
      stream_strip_cap=cal["strip_cap"], stream_slab_cap=cal["slab_cap"],
      stream_w_max=cal["w_max"], stream_run_cap=cal["run_cap"],
      stream_wide_cap=cal["wide_cap"], stream_dup_cap=cal["dup_cap"],
      big_tile_window=cal["big_tile_window"], **c.HEUR)
  m = stream_map_with_config(g2d, nd, feats, c.SIZE_FULL, cfg)
  tw, th = tile_shape(c.SIZE_FULL, cfg.tile_size)
  gen = torch.Generator(device=dev).manual_seed(7)
  tgt = entile(torch.rand((c.SIZE_FULL[1], c.SIZE_FULL[0], 3), generator=gen,
                          device=dev), tw, th, cfg.tile_size)
  mask = tile_mask(c.SIZE_FULL, tw, th, cfg.tile_size, device=dev)
  g2d = g2d.detach().requires_grad_(True)
  it = stream_rasterize_with_mapping(g2d, feats, m, c.SIZE_FULL, cfg,
                                     tiled=True)
  loss = (mask * (it[:, :3] - tgt) ** 2).sum()
  (g_it,) = torch.autograd.grad(loss, it)
  it = it.detach()
  del g3d, cams, g2d, depths, nd, feats, tgt, mask, loss

  def k2():
    return sk.stream_backward(m, it, g_it, cfg)
  k2()
  out["K2"] = (c.cuda_ms(k2, 5), c.device_ms(k2, reps=5))
  del m, it, g_it

  big = c.mosaic_at_scale(dev)
  flush = c.l2_flush(dev)
  x, w = big["T2"]
  out.update(c.timed_in_turns({
      "T2": lambda: em.reshape_rows(x, w),
      "clone": lambda: x.reshape(-1, w).clone()}, flush))
  del x
  x, s4, rows = big["T4"]
  out.update(c.timed_in_turns({
      "T4 bulk": lambda: em.dma_residue_sum(x, s4, rows, bulk=True),
      "T4 loads": lambda: em.dma_residue_sum(x, s4, rows, bulk=False)},
      flush))
  return out


def card() -> str:
  return subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True,
      check=True).stdout.strip().splitlines()[0]


def run_in(root: str) -> dict:
  """``--measure`` in the checkout ``root``, in a process of its own."""
  env = dict(os.environ, PYTHONPATH=os.path.abspath(root))
  proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                         "--measure"], cwd=root, env=env, capture_output=True,
                        text=True)
  sys.stdout.write(proc.stdout)
  if proc.returncode != 0:
    sys.stderr.write(proc.stderr[-4000:])
    raise SystemExit(f"turns: --measure failed in {root}")
  return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--other", help="the other checkout's root")
  parser.add_argument("--measure", action="store_true",
                      help="time the kernels of this checkout")
  args = parser.parse_args(argv)
  if not torch.cuda.is_available():
    raise SystemExit("turns: CUDA is not available")
  if args.measure:
    print(card(), flush=True)
    print(json.dumps(measure()), flush=True)
    return
  if not args.other:
    parser.error("--other DIR or --measure")
  here = os.path.dirname(os.path.dirname(os.path.dirname(
      os.path.abspath(__file__))))
  order = [("other", args.other), ("this", here), ("this", here),
           ("other", args.other)]
  got = {"other": [], "this": []}
  for name, root in order:
    got[name].append(run_in(root))
  print(card())
  for key in KEYS:
    cells = []
    for name in ("other", "this"):
      call = [r[key][0] for r in got[name] if key in r]
      dev = [r[key][1] for r in got[name] if key in r]
      cells.append(f"{name} a call {' / '.join(f'{v:.4f}' for v in call)} "
                   f"ms, device {' / '.join(f'{v:.4f}' for v in dev)} ms")
    print(f"{key}: " + "; ".join(cells))
  print(json.dumps(got))


if __name__ == "__main__":
  main()
