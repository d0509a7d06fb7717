"""Headline benchmark of the port: the counterpart of the repository's
``bench.py``.

    python -m tpu_splatting_torch.bench [--device cuda|cpu]
        [--group-width 8] [--n N] [--size W H]

Two synthetic scenes of ``--n`` splats (2M) at ``--size`` (2048x1536):
``scenes.uniform_scene`` (seed 0) and ``scenes.heavy_scene`` (seed 1,
3DGS-checkpoint statistics: log-normal scales up to 110 px, the wide-splat
duplication path).  Each is measured by the reference's 2D protocol
(``bench_scene``: one ``stream_map`` call, then one forward + backward of
the tiled loss with visibility and point heuristics), and the uniform one
also by the full renderer (``bench_full_renderer``: the splats lifted to
3D with SH degree 3, ``render_with_heuristics(..., use_sh=True,
tiled=True)`` with gradients of every ``Gaussians3D`` leaf), which is the
headline ``value``.

It prints the card's name and power limit as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` gives them, then one
JSON line with the reference's keys (``metric``, ``value``, ``unit``,
``group_width``, ``{scene}_map_ms``, ``{scene}_raster_ms``, ``{scene}_ms``,
``uniform_full_ms``, ``vs_baseline``) and ``device``.  Each mapping's
overflow by cause goes to standard error.

Where it differs from the reference:

* ``{scene}_ms`` is map plus raster as measured (CUDA events through
  ``utils.benchmarked``), with no per-dispatch constant added;
* no ``stream_passes``: split-bf16 passes are a TPU residual;
* ``--group-width`` replaces the environment variables;
* calibrations are the port's own ``calibrate_stream``, cached in
  ``tpu_splatting_torch/_build/bench_cal.json`` under a key of the scene,
  group width, splat count and image size, versioned by
  ``CAPACITY_SEMANTICS``; the repository's ``.bench_cal.json`` is neither
  read nor written;
* a scene that overflows or raises still gets its ``errors`` entry, and
  then the process exits 1; there is no fallback from the full renderer
  to the 2D frame;
* without a card it raises, unless ``--device cpu`` asks for the plain
  twins (host-clock times of the CPU, not of a device).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import traceback
from typing import Callable

import numpy as np
import torch

from .data_types import RasterConfig
from .mapper.tile_mapper import tile_shape
from .perspective.projection import ndc_depth, project_to_image
from .rasterizer.stream import (CAPACITY_SEMANTICS, StreamMapping,
                                calibrate_stream, stream_map)
from .rasterizer.stream_function import (entile, probe_width,
                                         stream_rasterize_with_mapping,
                                         tile_mask)
from .renderer import render_with_heuristics
from .scenes import heavy_scene, lift_to_3d, uniform_scene
from .utils.benchmarked import benchmarked
from .utils.cuda_build import BUILD_DIR

# the reference's published RTX 4090 number (BASELINE.md:
# diff_gaussian_rasterization, bicycle at 2048 px), not a measurement of
# this port
BASELINE_MS = 35.1
METRIC = "synthetic_bicycle_2048px_fwd_bwd"
IMAGE_SIZE = (2048, 1536)
N = 2_000_000
ITERS = 3
CAL_PATH = os.path.join(BUILD_DIR, "bench_cal.json")
# stream_map's capacities, as calibrate_stream names them
MAP_KEYS = ("num_slabs", "strip_cap", "slab_cap", "w_max", "run_cap",
            "wide_cap", "dup_cap")
SCENES = {"uniform": (uniform_scene, 0), "heavy": (heavy_scene, 1)}
# the full renderer's camera (bench.py: lift_to_3d's arguments)
NEAR, FAR, FOV_DEG = 0.1, 100.0, 70.0


def device_of(device) -> torch.device:
  """The torch device to run on; a CUDA device without a card raises."""
  dev = torch.device(device)
  if dev.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("tpu_splatting_torch.bench: CUDA is not available "
                       "(pass --device cpu for the plain twins)")
  return dev


def card_line(dev: torch.device) -> str:
  """The card's name and power limit as nvidia-smi prints them."""
  if dev.type != "cuda":
    return "device: cpu (no card: host-clock times of the plain twins)"
  smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
  return smi.stdout.strip().splitlines()[dev.index or 0]


def _cal_cached(key: str, compute: Callable[[], dict],
                force: bool = False) -> dict:
  """Disk-cached calibration dict at ``CAL_PATH``.  The key is versioned
  by ``CAPACITY_SEMANTICS``, so an entry from other capacity semantics is
  never reused; an entry that recorded overflow is recomputed."""
  try:
    with open(CAL_PATH) as fh:
      cache = json.load(fh)
  except FileNotFoundError:
    cache = {}
  key = f"{key}_v{CAPACITY_SEMANTICS}"
  entry = cache.get(key)
  if entry is not None and sum(entry.get("overflow", [1])) != 0:
    entry = None
  if entry is not None and not force:
    print(f"# calibration cache hit: {key}", file=sys.stderr)
    return entry
  cache[key] = {k: (v if isinstance(v, list) else int(v))
                for k, v in compute().items()}
  os.makedirs(os.path.dirname(CAL_PATH), exist_ok=True)
  tmp = f"{CAL_PATH}.{os.getpid()}.tmp"
  with open(tmp, "w") as fh:
    json.dump(cache, fh, indent=1, sort_keys=True)
  os.replace(tmp, CAL_PATH)
  return cache[key]


def _trainer_config(gw: int) -> RasterConfig:
  return RasterConfig(compute_point_heuristic=True, compute_visibility=True,
                      stream_group_width=gw)


def scene_arrays(name: str, n: int = N, image_size=IMAGE_SIZE):
  """The named scene's (packed, NDC depth, colours) numpy arrays."""
  gen, seed = SCENES[name]
  return gen(np.random.default_rng(seed), n, image_size)


def to_device(dev, *arrays):
  """numpy arrays -> tensors on ``dev``."""
  return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
               for x in arrays)


def calibrate_scene(name: str, packed, depth, feats, image_size, gw: int,
                    force: bool = False) -> dict:
  """The port's calibration of a 2D scene (tensors), through the cache."""
  w, h = image_size
  return _cal_cached(
      f"{name}_gw{gw}_n{packed.shape[0]}_{w}x{h}",
      lambda: calibrate_stream(packed, depth, feats, image_size,
                               _trainer_config(gw), group_width=gw), force)


def make_scene_step(image_size, config: RasterConfig, caps: dict):
  """The reference ``bench_scene``'s two timed closures:
  ``map_f(packed, depth, feats) -> StreamMapping`` and
  ``fwd_bwd(packed, feats, tgt, mask, mapping) -> (g_packed, g_feats,
  g_probe)``, the gradients of the tiled loss sum(mask * (image - tgt)^2)
  + sum(mask * weight) with a zero probe carrying visibility and the
  point heuristics.  ``caps`` go to ``stream_map``."""
  pw = probe_width(config)

  def map_f(packed, depth, feats) -> StreamMapping:
    return stream_map(packed, depth, feats, image_size, config, **caps)

  def fwd_bwd(packed, feats, tgt, mask, mapping):
    p = packed.detach().requires_grad_(True)
    f = feats.detach().requires_grad_(True)
    probe = torch.zeros((p.shape[0], pw), dtype=p.dtype, device=p.device,
                        requires_grad=True)
    it = stream_rasterize_with_mapping(p, f, mapping, image_size, config,
                                       probe=probe, tiled=True)
    err = it[:, :-1] - tgt
    loss = (mask * (err * err)).sum() + (mask[:, 0] * it[:, -1]).sum()
    return torch.autograd.grad(loss, (p, f, probe))

  return map_f, fwd_bwd


def loss_target(image_size, tile_size: int, dev):
  """The tiled loss's target (seed 7, entiled once, as the trainer does)
  and its (T, 1, PIX) mask of the pixels inside the image."""
  w, h = image_size
  tw, th = tile_shape(image_size, tile_size)
  full = torch.from_numpy(np.random.default_rng(7).random(
      (h, w, 3)).astype(np.float32)).to(dev)
  return (entile(full, tw, th, tile_size),
          tile_mask(image_size, tw, th, tile_size, device=dev))


@dataclasses.dataclass
class SceneSetup:
  """A calibrated, mapped 2D scene and its timed closures."""
  cal: dict
  config: RasterConfig
  caps: dict
  map_f: Callable
  fwd_bwd: Callable
  map_args: tuple        # (packed, depth, feats)
  raster_args: tuple     # (packed, feats, tgt, mask, mapping)

  @property
  def mapping(self) -> StreamMapping:
    return self.raster_args[-1]


def prepare_scene(name: str, packed, depth, feats, image_size,
                  gw: int) -> SceneSetup:
  """Calibrate (through the cache) and map a 2D scene of tensors.  A
  cached calibration that overflows is computed again; a mapping that
  still drops rows raises: its times would not be a benchmark."""
  def build(force):
    cal = calibrate_scene(name, packed, depth, feats, image_size, gw, force)
    print(f"# {name} calibration: {cal}", file=sys.stderr)
    cfg = dataclasses.replace(_trainer_config(gw),
                              big_tile_window=cal["big_tile_window"])
    caps = {**{k: cal[k] for k in MAP_KEYS}, "group_width": gw}
    map_f, fwd_bwd = make_scene_step(image_size, cfg, caps)
    return cal, cfg, caps, map_f, fwd_bwd, map_f(packed, depth, feats)

  built = build(False)
  if int(built[-1].num_overflow) != 0:
    built = build(True)
  cal, cfg, caps, map_f, fwd_bwd, m = built
  overflow, by_cause = int(m.num_overflow), m.overflow.tolist()
  print(f"# {name} overflow {overflow} by cause {by_cause}", file=sys.stderr)
  if overflow != 0:
    raise RuntimeError(f"{name}: benchmark invalid, {overflow} rows dropped "
                       f"(by cause {by_cause})")
  tgt, mask = loss_target(image_size, cfg.tile_size, packed.device)
  return SceneSetup(cal, cfg, caps, map_f, fwd_bwd, (packed, depth, feats),
                    (packed, feats, tgt, mask, m))


def bench_scene(name: str, packed, depth, feats, gw: int,
                image_size=IMAGE_SIZE, device="cuda",
                iters: int = ITERS) -> dict:
  """2D protocol on numpy arrays: the map call and the forward + backward
  call, each timed over ``iters`` calls."""
  dev = device_of(device)
  s = prepare_scene(name, *to_device(dev, packed, depth, feats), image_size,
                    gw)
  ms_map = benchmarked(f"{name} map", s.map_f, s.map_args, iters=iters)
  ms_raster = benchmarked(f"{name} fwd+bwd", s.fwd_bwd, s.raster_args,
                          iters=iters)
  return {f"{name}_map_ms": ms_map, f"{name}_raster_ms": ms_raster,
          f"{name}_ms": ms_map + ms_raster}


def calibrate_full(name: str, g3d, cam, feats, image_size, gw: int,
                   force: bool = False) -> dict:
  """The port's calibration of the projected splats of a 3D scene
  (``feats``: the scene's (N, 3) colours, which size the table), through
  the cache."""
  config = _trainer_config(gw)

  def compute():
    with torch.no_grad():
      g2d, depths, _ = project_to_image(g3d, cam, config)
      nd = torch.where(depths > 0,
                       ndc_depth(depths, cam.near_plane, cam.far_plane), 0.0)
      return calibrate_stream(g2d, nd, feats, image_size, config,
                              group_width=gw)

  w, h = image_size
  return _cal_cached(f"{name}_full_gw{gw}_n{feats.shape[0]}_{w}x{h}",
                     compute, force)


def full_config(cal: dict, gw: int) -> RasterConfig:
  """The trainer config with the calibrated capacities as its knobs."""
  return dataclasses.replace(
      _trainer_config(gw), stream_num_slabs=cal["num_slabs"],
      stream_strip_cap=cal["strip_cap"], stream_slab_cap=cal["slab_cap"],
      stream_w_max=cal["w_max"], stream_run_cap=cal["run_cap"],
      stream_wide_cap=cal["wide_cap"], stream_dup_cap=cal["dup_cap"],
      big_tile_window=cal["big_tile_window"])


def make_full_step(cam, config: RasterConfig, tgt, mask):
  """The reference ``bench_full_renderer``'s timed step: ``step(g3d) ->
  (loss, grads, num_overflow, overflow_by_cause)``, one
  ``render_with_heuristics(..., use_sh=True, tiled=True)`` of the masked
  L2 loss against the entiled target, gradients of every leaf."""
  def loss_fn(rendering):
    err = rendering.image - tgt                  # (T, 3, PIX)
    return (mask * (err * err)).sum()

  def step(g3d):
    loss, rendering, grads = render_with_heuristics(
        loss_fn, g3d, cam, config, use_sh=True, tiled=True)
    return loss, grads, rendering.num_overflow, rendering.overflow_by_cause

  return step


def lift_and_calibrate(name: str, packed, depth, feats, gw: int,
                       image_size=IMAGE_SIZE, device="cuda"):
  """The 2D scene (numpy) lifted to 3D on the device and calibrated on
  its projected splats (through the cache): (g3d, camera, calibration)."""
  dev = device_of(device)
  g3d, cam = lift_to_3d(packed, depth, feats, image_size, near=NEAR,
                        far=FAR, fov_deg=FOV_DEG, device=dev)
  cal = calibrate_full(name, g3d, cam, to_device(dev, feats)[0], image_size,
                       gw)
  print(f"# {name} full-renderer calibration: {cal}", file=sys.stderr)
  return g3d, cam, cal


def prepare_full(name: str, packed, depth, feats, gw: int,
                 image_size=IMAGE_SIZE, device="cuda"):
  """``lift_and_calibrate``, then the timed step: (step, g3d, camera,
  config)."""
  dev = device_of(device)
  g3d, cam, cal = lift_and_calibrate(name, packed, depth, feats, gw,
                                     image_size, dev)
  cfg = full_config(cal, gw)
  tgt, mask = loss_target(image_size, cfg.tile_size, dev)
  return make_full_step(cam, cfg, tgt, mask), g3d, cam, cfg


def bench_full_renderer(name: str, packed, depth, feats, gw: int,
                        image_size=IMAGE_SIZE, device="cuda",
                        iters: int = ITERS) -> dict:
  """Reference protocol: projection, SH degree 3, mapping and the
  rasterizer's forward + backward with heuristics, timed as one step."""
  step, g3d, _, _ = prepare_full(name, packed, depth, feats, gw,
                                 image_size, device)
  _, _, overflow, by_cause = step(g3d)
  overflow, by_cause = int(overflow), by_cause.tolist()
  print(f"# {name} full overflow {overflow} by cause {by_cause}",
        file=sys.stderr)
  if overflow != 0:
    raise RuntimeError(f"{name} full: benchmark invalid, {overflow} rows "
                       f"dropped (by cause {by_cause})")
  ms = benchmarked(f"{name} full renderer", step, (g3d,), iters=iters)
  return {f"{name}_full_ms": ms}


def run(device="cuda", gw: int = 8, n: int = N, image_size=IMAGE_SIZE,
        iters: int = ITERS) -> dict:
  """Every scene, then the full renderer: the JSON line's dict.  A scene
  that raises is recorded under ``errors`` (its traceback on standard
  error) and the others still run."""
  dev = device_of(device)
  out = {"metric": METRIC, "unit": "ms", "group_width": gw,
         "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                    else "cpu")}
  errors = {}
  scenes = {name: scene_arrays(name, n, image_size) for name in SCENES}
  for name, (p, d, f) in scenes.items():
    try:
      out.update(bench_scene(name, p, d, f, gw, image_size, dev, iters))
    except Exception as e:    # reported beside the other scenes' numbers
      traceback.print_exc()
      errors[name] = f"{type(e).__name__}: {e}"[:200]
  try:
    out.update(bench_full_renderer("uniform", *scenes["uniform"], gw,
                                   image_size, dev, iters=iters))
  except Exception as e:
    traceback.print_exc()
    errors["uniform_full"] = f"{type(e).__name__}: {e}"[:200]
  ms = out.get("uniform_full_ms")
  out["value"] = ms if ms is not None else -1
  out["vs_baseline"] = BASELINE_MS / ms if ms is not None else 0.0
  if errors:
    out["errors"] = errors
  return out


def parse_args(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--device", default="cuda",
                      help="cuda (the default) or cpu (the plain twins)")
  parser.add_argument("--group-width", type=int, default=8,
                      help="stream group width (8: the headline's)")
  parser.add_argument("--n", type=int, default=N, help="splats per scene")
  parser.add_argument("--size", type=int, nargs=2, default=IMAGE_SIZE,
                      metavar=("W", "H"), help="image size")
  return parser.parse_args(argv)


def main(argv=None) -> int:
  """Prints the card line and the JSON line; 1 if a scene failed."""
  args = parse_args(argv)
  dev = device_of(args.device)
  print(card_line(dev), flush=True)
  out = run(dev, args.group_width, args.n, tuple(args.size))
  print(json.dumps(out), flush=True)
  return 1 if "errors" in out else 0


if __name__ == "__main__":
  sys.exit(main())
