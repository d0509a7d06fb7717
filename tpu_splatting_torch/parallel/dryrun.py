"""The multi-device dry run: every sharded path once, at tiny shapes.

The port's own copy of the reference's ``dryrun_multichip``
(``__graft_entry__.py``): a data-parallel training step over an n-shard
mesh (finite loss), the point-sharded projection (every point gathered)
and the band-sharded stream gradient (finite), the same three checks at
the same shapes.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..data_types import Gaussians3D, RasterConfig
from ..optim import GroupConfig
from ..perspective.params import CameraParams
from ..rasterizer.stream import stream_map
from .data_parallel import make_train_step, sharded_projection
from .mesh import make_mesh
from .stream_sharded import band_sharded_grad


def _synthetic_scene(n: int, image_size, seed: int = 0, device="cuda"):
  """(gaussians, camera): n random gaussians 1-50 units in front of an
  identity camera, from a seed."""
  rng = np.random.default_rng(seed)
  w, h = image_size
  z = rng.uniform(1.0, 50.0, n)

  def t(x):
    return torch.as_tensor(np.asarray(x, np.float32), device=device)

  gaussians = Gaussians3D(
      position=t(np.stack([rng.uniform(-0.5, 0.5, n) * z,
                           rng.uniform(-0.4, 0.4, n) * z, z], 1)),
      log_scaling=t(rng.normal(-3.0, 0.5, (n, 3))),
      rotation=t(rng.normal(size=(n, 4))),
      alpha_logit=t(rng.normal(0.0, 1.0, (n, 1))),
      feature=t(rng.random((n, 3))))
  camera = CameraParams(
      projection=t([w * 1.2, w * 1.2, w / 2, h / 2]),
      T_camera_world=torch.eye(4, dtype=torch.float32, device=device),
      near_plane=0.1, far_plane=100.0, image_size=image_size)
  return gaussians, camera


def dryrun_multichip(n_devices: int,
                     devices: Optional[Sequence] = None) -> None:
  """One data-parallel training step over an n-shard mesh, the
  point-sharded projection and the band-sharded stream gradient, at tiny
  shapes.  ``devices``: the mesh's devices (repeats allowed: virtual
  shards); by default the visible CUDA devices."""
  mesh = make_mesh(n_devices, devices=devices)
  dev = mesh.devices[0]
  image_size = (64, 48)
  n_points = 64 * n_devices
  gaussians, camera = _synthetic_scene(n_points, image_size, seed=1,
                                       device=dev)
  config = RasterConfig(tile_size=16, chunk_size=16)
  groups = {
      "position": GroupConfig(type="vector", lr=0.001),
      "log_scaling": GroupConfig(type="scalar", lr=0.001),
      "rotation": GroupConfig(type="scalar", lr=0.001),
      "alpha_logit": GroupConfig(type="scalar", lr=0.001),
      "feature": GroupConfig(type="vector", lr=0.001),
  }
  train_step, optimizer = make_train_step(
      mesh, camera, config, groups, max_overlaps=4096)
  tensors = {k: getattr(gaussians, k) for k in groups}
  opt_state = optimizer.init(tensors)

  # the camera batch: one camera a shard
  rng = np.random.default_rng(2)
  b = n_devices
  projections = camera.projection.repeat(b, 1)
  poses = camera.T_camera_world.repeat(b, 1, 1)
  targets = torch.as_tensor(
      rng.random((b, image_size[1], image_size[0], 3)).astype(np.float32),
      device=dev)
  _, _, loss = train_step(tensors, opt_state, projections, poses, targets)
  assert bool(torch.isfinite(loss)), f"non-finite loss {loss}"

  # point-sharded projection, gathered
  points, _, in_view = sharded_projection(mesh, camera, config)(gaussians)
  assert points.shape == (n_points, 7), points.shape

  # band-sharded single-camera stream rasterization: one tile band a shard
  w, h = 32, 16 * n_devices
  n2 = 256
  rng2 = np.random.default_rng(3)
  packed = np.zeros((n2, 7), np.float32)
  packed[:, 0] = rng2.uniform(0, w, n2)
  packed[:, 1] = rng2.uniform(0, h, n2)
  th_ = rng2.uniform(0, np.pi, n2)
  packed[:, 2] = np.cos(th_)
  packed[:, 3] = np.sin(th_)
  packed[:, 4:6] = (rng2.random((n2, 2)) + 0.2) * 2.0
  packed[:, 6] = rng2.uniform(0.1, 0.9, n2)
  depth2 = (rng2.permutation(n2).astype(np.float32) + 0.5) / n2
  feats2 = rng2.random((n2, 3)).astype(np.float32)
  scfg = RasterConfig()
  mm = stream_map(torch.as_tensor(packed, device=dev),
                  torch.as_tensor(depth2, device=dev),
                  torch.as_tensor(feats2, device=dev), (w, h), scfg,
                  group_width=2, num_slabs=2, strip_cap=512, slab_cap=256,
                  w_max=32, run_cap=64)
  gimg = torch.ones((mm.num_tiles, feats2.shape[1] + 1, scfg.tile_area),
                    dtype=torch.float32, device=dev)
  _, cols = band_sharded_grad(mm, gimg, scfg, mesh)
  assert bool(torch.isfinite(cols).all())

  print(f"dryrun_multichip({n_devices}): loss={float(loss):.5f}, "
        f"projected {int(in_view.sum())}/{n_points} in view, "
        f"band-sharded stream grad finite — OK")
