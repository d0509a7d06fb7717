"""A single-process device mesh and the three collectives its two
sharded paths use.

The reference's multi-device code is single-controller: one process, a
``jax.sharding.Mesh`` over a list of devices, ``shard_map`` bodies that
trade data with ``ppermute``, ``all_gather`` and ``psum``.  Here a
``Mesh`` is a tuple of ``torch.device``s, a shard body is a Python loop
over them, and a collective is a copy (``Tensor.to``) onto the receiving
shard's device.  A device may be listed more than once (virtual shards:
the tests' CPU mesh, one card's multi-shard runs), the counterpart of
XLA's ``--xla_force_host_platform_device_count``; a copy to the same
device is then no copy at all.  Copies are differentiable, so gradients
flowing back through ``psum`` and ``all_gather`` land on each shard's
inputs as the reference's collectives' transposes deliver them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
  """A one-axis mesh: ``devices[d]`` holds shard d.  With one axis the
  reference's axis names select nothing, so the port has none."""
  devices: Tuple[torch.device, ...]

  @property
  def size(self) -> int:
    return len(self.devices)


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
  """A mesh over ``devices`` (entries may repeat), or by default over the
  visible CUDA devices; ``n_devices`` takes the first n and asserts there
  are that many."""
  if devices is None:
    devices = [torch.device("cuda", i)
               for i in range(torch.cuda.device_count())]
    assert devices, "make_mesh: no CUDA device is visible"
  devices = [torch.device(d) for d in devices]
  if n_devices is not None:
    assert len(devices) >= n_devices, (
        f"need {n_devices} devices, have {len(devices)}")
    devices = devices[:n_devices]
  return Mesh(tuple(devices))


def ppermute(mesh: Mesh, xs, perm):
  """``xs[src]`` copied to ``mesh.devices[dst]`` for each (src, dst) of
  ``perm``, as a list by destination; None where no shard sends (the
  reference's ``ppermute`` delivers zeros there)."""
  out = [None] * mesh.size
  for src, dst in perm:
    out[dst] = xs[src].to(mesh.devices[dst])
  return out


def all_gather(mesh: Mesh, xs, dim: int = 0) -> torch.Tensor:
  """The shards' tensors concatenated along ``dim`` on the first device."""
  return torch.cat([x.to(mesh.devices[0]) for x in xs], dim)


def psum(mesh: Mesh, xs) -> torch.Tensor:
  """The sum of the shards' tensors, on the first device."""
  total = xs[0].to(mesh.devices[0])
  for x in xs[1:]:
    total = total + x.to(mesh.devices[0])
  return total
