"""Carry the JAX package's data into the port.

Inputs are plain numpy arrays and dicts (for example ``jax.device_get``
of a pytree, or ``dataclasses.asdict`` of a config), so this module needs
no JAX: a mapping, a scene or a config built by the reference can be fed
to the port as it is.  Tensors land on the card unless ``device`` says
otherwise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .data_types import Gaussians3D, RasterConfig
from .mapper.tile_mapper import TileMapping
from .perspective.params import CameraParams
from .rasterizer.stream import StreamMapping


def _tensor(x, device, dtype=None):
  return torch.as_tensor(np.array(x, copy=True), device=device, dtype=dtype)


def gaussians3d_from_numpy(d: dict, device="cuda") -> Gaussians3D:
  """{position, log_scaling, rotation, alpha_logit, feature} arrays."""
  return Gaussians3D(**{f.name: _tensor(d[f.name], device)
                        for f in dataclasses.fields(Gaussians3D)})


def camera_from_numpy(d: dict, device="cuda") -> CameraParams:
  """{projection, T_camera_world, near_plane, far_plane, image_size[, id]}."""
  return CameraParams(
      projection=_tensor(d["projection"], device),
      T_camera_world=_tensor(d["T_camera_world"], device),
      near_plane=float(d["near_plane"]), far_plane=float(d["far_plane"]),
      image_size=tuple(int(x) for x in d["image_size"]),
      id=d.get("id"))


def raster_config_from_dict(d: dict) -> RasterConfig:
  """A RasterConfig from ``dataclasses.asdict`` of the reference's (every
  field and default is shared; tuples may arrive as lists)."""
  names = {f.name for f in dataclasses.fields(RasterConfig)}
  unknown = set(d) - names
  if unknown:
    raise ValueError(f"unknown RasterConfig fields: {sorted(unknown)}")
  return RasterConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in d.items()})


MAPPING_INT_FIELDS = ("pid_order", "desc", "strip_blk", "run_starts",
                      "num_overflow", "overflow", "grad_src", "dup_src",
                      "dup_pid")


def stream_mapping_from_numpy(d: dict, device="cuda") -> StreamMapping:
  """A StreamMapping from the reference's fields (arrays + static ints)."""
  kw = {}
  for f in dataclasses.fields(StreamMapping):
    if f.name not in d:
      continue
    v = d[f.name]
    if f.name == "table":
      kw[f.name] = _tensor(v, device, torch.float32)
    elif f.name in MAPPING_INT_FIELDS:
      kw[f.name] = _tensor(np.asarray(v).astype(np.int32), device)
    else:
      kw[f.name] = int(v)
  return StreamMapping(**kw)


TILE_MAPPING_INT_FIELDS = ("overlap_to_point", "tile_ranges", "chunk_to_tile",
                           "chunk_src", "chunk_cnt", "num_overflow")


def tile_mapping_from_numpy(d: dict, device="cuda") -> TileMapping:
  """A TileMapping (sorted pipeline) from the reference's fields: integer
  arrays as int32, ``sorted_payload`` in its own float type (or None),
  static ints as they are (``feature_size`` may be None)."""
  kw = {}
  for f in dataclasses.fields(TileMapping):
    v = d[f.name]
    if f.name in TILE_MAPPING_INT_FIELDS:
      kw[f.name] = _tensor(np.asarray(v).astype(np.int32), device)
    elif f.name == "sorted_payload":
      kw[f.name] = None if v is None else _tensor(v, device)
    else:
      kw[f.name] = None if v is None else int(v)
  return TileMapping(**kw)
