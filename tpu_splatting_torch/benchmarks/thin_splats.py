"""f32 against f64 on sub-pixel-thin splats (ROADMAP F16, F20).

    python -m tpu_splatting_torch.benchmarks.thin_splats [--device cpu]

prints, on the card unless ``--device cpu`` is given (the twins):

* the bench's heavy scene at 2,000 splats and 128x96 (31 splats thinner
  than 0.1 px): the scene step's f32 packed-gaussian gradient of those
  splats against the port's f64 twins on the CPU, per column, as a share
  of the column's largest (F16: within 1e-4);
* ``thin_scene``: the f32 forward image against the f64 one (F20), and
  the f32 stream backward against the f64 twin, on the f32 forward's image
  and on the same image (the backward's own error), per column, shares of
  the column's largest.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

THIN = 0.1   # px: a splat whose thinner axis is below this is thin


def thin_scene():
  """48 splats on 2x4 tiles of 8 px, 36 of them 0.03-0.1 px thin across
  and 2-6 px long, the rest 0.5-2 px: (packed, depths, features, size)."""
  rng = np.random.default_rng(16)
  n, n_thin = 48, 36
  packed = np.zeros((n, 7), np.float32)
  packed[:, 0] = rng.uniform(2.0, 14.0, n)
  packed[:, 1] = rng.uniform(2.0, 30.0, n)
  theta = rng.uniform(0, np.pi, n)
  packed[:, 2] = np.cos(theta)
  packed[:, 3] = np.sin(theta)
  packed[:, 4:6] = rng.uniform(0.5, 2.0, (n, 2))
  thin = rng.uniform(0.03, 0.1, n_thin)
  long = rng.uniform(2.0, 6.0, n_thin)
  thin_x = rng.random(n_thin) < 0.5
  packed[:n_thin, 4] = np.where(thin_x, thin, long)
  packed[:n_thin, 5] = np.where(thin_x, long, thin)
  packed[:, 6] = rng.uniform(0.3, 0.95, n)
  depths = (rng.permutation(n).astype(np.float32) + 0.5) / n
  feats = rng.random((n, 3)).astype(np.float32)
  return packed, depths, feats, (16, 32)


def mapping_to(m, dev):
  """The mapping with every tensor field on ``dev``."""
  return dataclasses.replace(m, **{
      f.name: getattr(m, f.name).to(dev) for f in dataclasses.fields(m)
      if isinstance(getattr(m, f.name), torch.Tensor)})


def column_share(got, want):
  """Per column: max |got - want| / max |want|."""
  want = want.double()
  return ((got.double() - want).abs().amax(0)
          / want.abs().amax(0).clamp(min=1e-300))


def heavy_thin_share(dev) -> torch.Tensor:
  """F16: the heavy scene's step on ``dev`` in f32 against the f64 twins
  on the CPU, on the thin splats' rows: per-column shares."""
  from .. import bench
  size, gw = (128, 96), 8
  arrays = bench.scene_arrays("heavy", 2000, size)
  cfg = bench._trainer_config(gw)
  p, d, f = (torch.from_numpy(x).to(dev) for x in arrays)
  cal = bench.calibrate_stream(p, d, f, size, cfg, group_width=gw)
  caps = {**{k: cal[k] for k in bench.MAP_KEYS}, "group_width": gw}
  cfg = dataclasses.replace(cfg, big_tile_window=cal["big_tile_window"])
  map_f, fwd_bwd = bench.make_scene_step(size, cfg, caps)
  m = map_f(p, d, f)
  if int(m.num_overflow):
    raise RuntimeError(f"thin_splats: overflow {m.overflow.tolist()}")
  tgt, mask = bench.loss_target(size, cfg.tile_size, dev)
  g = fwd_bwd(p, f, tgt, mask, m)[0].cpu()
  m64 = mapping_to(dataclasses.replace(m, table=m.table.double()), "cpu")
  g64 = fwd_bwd(*(x.double().cpu() for x in (p, f, tgt, mask)), m64)[0]
  thin = torch.from_numpy(arrays[0][:, 4:6].min(1) < THIN)
  return ((g - g64).abs()[thin].amax(0) / g64.abs().amax(0)).double()


def thin_scene_shares(dev) -> dict:
  """F20 on ``thin_scene`` (quadratic mode, tile 8): the f32 forward
  image's largest difference from the f64 one, and the f32 backward's
  per-column shares against the f64 twin on its own forward's image and
  on the f32 image (the same inputs)."""
  from ..data_types import RasterConfig
  from ..rasterizer import stream_kernels as sk
  from ..rasterizer.stream import stream_map
  packed, depths, feats, size = thin_scene()
  cfg = RasterConfig(tile_size=8, chunk_size=8, big_tile_window=16)
  m = stream_map(*(torch.from_numpy(x).to(dev) for x in (packed, depths,
                                                         feats)),
                 size, cfg, group_width=2, num_slabs=2, strip_cap=128,
                 slab_cap=256, w_max=16, run_cap=32)
  if int(m.num_overflow):
    raise RuntimeError(f"thin_splats: overflow {m.overflow.tolist()}")
  img = sk.stream_forward(m, cfg)
  gimg = torch.from_numpy(np.random.default_rng(2).standard_normal(
      tuple(img.shape)).astype(np.float32)).to(dev)
  got = sk.stream_backward(m, img, gimg, cfg).cpu()
  m64 = mapping_to(dataclasses.replace(m, table=m.table.double()), "cpu")
  img64 = sk.stream_forward(m64, cfg)
  img, gimg = img.cpu(), gimg.cpu()
  return {
      "forward_max_abs": float((img.double() - img64).abs().max()),
      "backward_own_image": column_share(got, sk.stream_backward(
          m64, img64, gimg.double(), cfg)),
      "backward_same_image": column_share(got, sk.stream_backward(
          m64, img.double(), gimg.double(), cfg)),
  }


def _fmt(x):
  return "[" + ", ".join(f"{v:.3e}" for v in x.tolist()) + "]"


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--device", default="cuda",
                      help="cuda (the default) or cpu (the plain twins)")
  dev = torch.device(parser.parse_args(argv).device)
  if dev.type == "cuda" and not torch.cuda.is_available():
    raise SystemExit("thin_splats: CUDA is not available (use --device "
                     "cpu for the plain twins)")
  print(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}")
  print(f"heavy 2,000 splats at 128x96, thin rows, f32 against f64 per "
        f"column: {_fmt(heavy_thin_share(dev))}")
  t = thin_scene_shares(dev)
  print(f"thin scene: forward image f32 against f64, max abs "
        f"{t['forward_max_abs']:.3e}")
  print(f"thin scene: backward f32 against f64, on its own forward's "
        f"image: {_fmt(t['backward_own_image'])}")
  print(f"thin scene: backward f32 against f64, on the same image: "
        f"{_fmt(t['backward_same_image'])}")


if __name__ == "__main__":
  main()
