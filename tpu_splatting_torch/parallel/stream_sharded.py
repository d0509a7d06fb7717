"""Band-sharded single-camera stream rasterization over a device mesh.

Counterpart of ``tpu_splatting/parallel/stream_sharded.py``.  The stream
group grid is band-major, so sharding along y is a contiguous split of
every per-group array: shard d owns tile bands [d*th_local,
(d+1)*th_local).  The home-sorted table and the run starts are
replicated; descriptors, strip blocks, the tiled image and its cotangent
are band-sharded.

Forward: no collective but the final gather.  Each shard runs K1 on its
bands with ``band0 = d * th_local`` (its absolute first band), so every
tile is composited bit for bit as the unsharded ``stream_forward`` does.

Backward: each shard runs K2 in halo mode into a buffer of th_local + 2
bands of homes: its own, and one halo band above and below for the rows
its edge tiles reach across the shard boundary.  Two ``ppermute``s send
each shard's halo bands to the neighbours they belong to, the halo merge
(K3's halo mode, ``stream_kernels.halo_merge``) adds them into the
receiving shard's edge bands, and the merged own bands are gathered,
with the zero row, into the unsharded (T * run_cap + 1, slabw)
home-major buffer.  Stage 2 (``reduce_stage2``) then runs once on the
first device with the global mapping.
"""

from __future__ import annotations

import dataclasses

import torch

from ..data_types import RasterConfig
from ..rasterizer.stream import StreamMapping
from ..rasterizer.stream_function import reduce_stage2
from ..rasterizer.stream_kernels import (halo_merge, stream_backward,
                                         stream_forward)
from .mesh import Mesh, all_gather, ppermute


def _local_mapping(mapping: StreamMapping, d: int, th_local: int,
                   device) -> StreamMapping:
  """Shard d's mapping on ``device``: its groups' descriptors and strip
  blocks, the replicated table and run starts, th_local bands.  The
  stage-2 fields (read once, after the gather, from the global mapping)
  are left out."""
  gpb = mapping.tiles_wide // mapping.group_width * th_local
  groups = slice(d * gpb, (d + 1) * gpb)
  empty = torch.zeros((0,), dtype=torch.int32, device=device)
  return dataclasses.replace(
      mapping, table=mapping.table.to(device),
      desc=mapping.desc[groups].to(device),
      strip_blk=mapping.strip_blk[groups].to(device),
      run_starts=mapping.run_starts.to(device), pid_order=empty,
      grad_src=empty, dup_src=empty, dup_pid=empty, tiles_high=th_local,
      num_tiles=mapping.tiles_wide * th_local)


def _shards(mapping: StreamMapping, mesh: Mesh):
  """(th_local, [(d, band0, device, local mapping)])."""
  n_dev = mesh.size
  th = mapping.tiles_high
  assert th % n_dev == 0, (th, n_dev)
  th_local = th // n_dev
  return th_local, [(d, d * th_local, dev,
                     _local_mapping(mapping, d, th_local, dev))
                    for d, dev in enumerate(mesh.devices)]


def band_sharded_forward(mapping: StreamMapping, config: RasterConfig,
                         mesh: Mesh) -> torch.Tensor:
  """Forward render with the group grid band-sharded over ``mesh``: the
  (T, F+1, PIX) tiled image on ``mesh.devices[0]``, bit for bit the
  unsharded ``stream_forward``'s."""
  _, shards = _shards(mapping, mesh)
  return all_gather(mesh, [stream_forward(lm, config, band0)
                           for _, band0, _, lm in shards])


def band_sharded_grad(mapping: StreamMapping, g_image_tiled: torch.Tensor,
                      config: RasterConfig, mesh: Mesh):
  """Forward + backward with band-sharded kernels.

  ``g_image_tiled`` (T, F+1, PIX): the loss cotangent in tile layout.
  Returns (image_tiled, (N, slabw) per-point gradients in the caller's
  point order), both on ``mesh.devices[0]``."""
  th_local, shards = _shards(mapping, mesh)
  n_dev = len(shards)
  t_local = mapping.tiles_wide * th_local
  band_rows = mapping.tiles_wide * mapping.run_cap
  imgs, bufs = [], []
  for d, band0, dev, lm in shards:
    img = stream_forward(lm, config, band0)
    gimg = g_image_tiled[d * t_local:(d + 1) * t_local].to(dev)
    imgs.append(img)
    bufs.append(stream_backward(lm, img, gimg, config, band0, halo=True))

  # halo exchange: shard d's bottom halo band holds rows homed in shard
  # d+1's first band, its top halo band rows homed in shard d-1's last
  top = [b[:band_rows] for b in bufs]
  bot = [b[(th_local + 1) * band_rows:(th_local + 2) * band_rows]
         for b in bufs]
  halo_above = ppermute(mesh, bot, [(i, i + 1) for i in range(n_dev - 1)])
  halo_below = ppermute(mesh, top, [(i, i - 1) for i in range(1, n_dev)])
  own = [halo_merge(b, th_local, band_rows, halo_above[d], halo_below[d])
         for d, b in enumerate(bufs)]
  buf = all_gather(mesh, own + [bufs[0][-1:]])          # + the zero row
  dev0 = mesh.devices[0]
  stage2 = dataclasses.replace(
      mapping, grad_src=mapping.grad_src.to(dev0),
      dup_src=mapping.dup_src.to(dev0), dup_pid=mapping.dup_pid.to(dev0))
  return all_gather(mesh, imgs), reduce_stage2(buf, stage2)
