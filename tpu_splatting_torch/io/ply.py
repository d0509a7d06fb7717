"""PLY point-cloud IO: 3DGS checkpoints to and from ``Gaussians3D``.

Counterpart of ``tpu_splatting/io/ply.py``.  Loads and saves 3D gaussian
scenes in the standard 3DGS PLY checkpoint layout (x, y, z, nx, ny, nz,
f_dc_*, f_rest_*, opacity, scale_*, rot_*).  The bulk parse and
de-interleave run in the port's own ``csrc/ply_io.cpp``, built with
``g++`` into ``_build/`` at first use (``utils.cuda_build.
load_host_library``) and bound with ``ctypes``.  Where it cannot be built,
``read_ply_raw`` and ``write_ply_raw`` raise: there is no silent numpy
fallback.  ``_read_ply_raw_numpy`` is a second, explicit reader (the tests
hold the native one to it) and, like the native reader, rejects a vertex
property that is not a float.

Conventions: 3DGS PLY stores quaternions as (w, x, y, z), the package
uses xyzw (scalar last); ``f_rest_{i * (B - 1) + j}`` is channel ``i``'s
coefficient ``j + 1`` (channel-major); ``nx``, ``ny``, ``nz`` are written
as zeros.  A file written here is byte for byte the reference's.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from ..data_types import Gaussians3D

__all__ = ["load_gaussians", "save_gaussians", "read_ply_raw",
           "write_ply_raw"]


def _lib() -> ctypes.CDLL:
  """The native reader / writer, built at first use (RuntimeError where
  ``g++`` is missing or fails)."""
  from ..utils.cuda_build import load_host_library
  lib = load_host_library("ply_io.cpp")
  lib.ply_inspect.restype = ctypes.c_int64
  lib.ply_inspect.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                              ctypes.c_char_p, ctypes.c_int64]
  lib.ply_read.restype = ctypes.c_int64
  lib.ply_read.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                           ctypes.c_int64]
  lib.ply_write.restype = ctypes.c_int64
  lib.ply_write.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                            ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p]
  lib.ply_last_error.restype = ctypes.c_char_p
  return lib


# ---------------------------------------------------------------------------
# raw property-table IO
# ---------------------------------------------------------------------------


def read_ply_raw(path: str) -> Dict[str, np.ndarray]:
  """Read all float vertex properties as {name: (N,) float32}."""
  lib = _lib()
  n_props = ctypes.c_int64()
  names_buf = ctypes.create_string_buffer(1 << 16)
  n = lib.ply_inspect(str(path).encode(), ctypes.byref(n_props), names_buf,
                      len(names_buf))
  if n < 0:
    raise IOError(f"ply_inspect: {lib.ply_last_error().decode()}")
  names = names_buf.value.decode().split("\n")
  out = np.empty((n_props.value, n), np.float32)
  r = lib.ply_read(str(path).encode(),
                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                   out.size)
  if r < 0:
    raise IOError(f"ply_read: {lib.ply_last_error().decode()}")
  return {name: out[i] for i, name in enumerate(names)}


def _read_ply_raw_numpy(path: str) -> Dict[str, np.ndarray]:
  """``read_ply_raw`` in numpy, with the native reader's header rules:
  binary little-endian only, the properties of the vertex element only,
  each of them a float (IOError otherwise), the payload from the end of
  the header."""
  names = []
  n = 0
  in_vertex = False
  with open(path, "rb") as f:
    if f.readline().strip() != b"ply":
      raise IOError("not a PLY file")
    while True:
      line = f.readline()
      if not line:
        raise IOError("missing end_header")
      s = line.decode().strip()
      if s.startswith("format "):
        if "binary_little_endian" not in s:
          raise IOError("only binary_little_endian PLY is supported")
      elif s.startswith("element vertex "):
        n = int(s.split()[-1])
        in_vertex = True
      elif s.startswith("element "):
        in_vertex = False
      elif s.startswith("property ") and in_vertex:
        if s.split()[1] not in ("float", "float32"):
          raise IOError(f"non-float vertex property: {s}")
        names.append(s.split()[-1])
      elif s == "end_header":
        break
    if n == 0 or not names:
      raise IOError("no vertex element found")
    data = np.fromfile(f, dtype="<f4", count=n * len(names))
  if data.size != n * len(names):
    raise IOError("short read")
  data = data.reshape(n, len(names))
  return {name: np.ascontiguousarray(data[:, i])
          for i, name in enumerate(names)}


def write_ply_raw(path: str, props: Dict[str, np.ndarray]):
  """Write {name: (N,) values} as float vertex properties, in the dict's
  order."""
  names = list(props.keys())
  n = len(next(iter(props.values())))
  table = np.ascontiguousarray(
      np.stack([np.asarray(props[k], np.float32) for k in names]))
  lib = _lib()
  r = lib.ply_write(str(path).encode(),
                    table.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    n, len(names), "\n".join(names).encode())
  if r < 0:
    raise IOError(f"ply_write: {lib.ply_last_error().decode()}")


# ---------------------------------------------------------------------------
# Gaussians3D <-> 3DGS PLY layout
# ---------------------------------------------------------------------------


def _gaussians_from_props(props: Dict[str, np.ndarray],
                          device) -> Gaussians3D:
  """A raw property table in the 3DGS layout -> Gaussians3D on
  ``device``."""
  n = len(props["x"])
  position = np.stack([props["x"], props["y"], props["z"]], 1)
  log_scaling = np.stack([props[f"scale_{i}"] for i in range(3)], 1)
  # 3DGS rot_* is (w, x, y, z); convert to xyzw
  rot_wxyz = np.stack([props[f"rot_{i}"] for i in range(4)], 1)
  rotation = np.concatenate([rot_wxyz[:, 1:4], rot_wxyz[:, 0:1]], 1)
  alpha_logit = props["opacity"][:, None]

  dc = np.stack([props[f"f_dc_{i}"] for i in range(3)], 1)   # (N, 3)
  rest_names = sorted(
      (k for k in props if k.startswith("f_rest_")),
      key=lambda s: int(s.split("_")[-1]))
  if rest_names:
    rest = np.stack([props[k] for k in rest_names], 1)       # (N, 3*(B-1))
    b = len(rest_names) // 3 + 1
    feature = np.concatenate(
        [dc[:, :, None], rest.reshape(n, 3, b - 1)], 2)      # (N, 3, B)
  else:
    feature = dc[:, :, None]

  def t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
  return Gaussians3D(position=t(position), log_scaling=t(log_scaling),
                     rotation=t(rotation), alpha_logit=t(alpha_logit),
                     feature=t(feature))


def load_gaussians(path: str, device="cuda") -> Gaussians3D:
  """Load a 3DGS checkpoint PLY into Gaussians3D (SH feature layout
  (N, 3, B)) on ``device``: the card unless the caller asks for the CPU
  (RuntimeError where there is no card)."""
  device = torch.device(device)
  if device.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("load_gaussians: CUDA is not available (pass "
                       "device='cpu')")
  return _gaussians_from_props(read_ply_raw(path), device)


def _numpy(x) -> np.ndarray:
  return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x,
                    np.float32)


def save_gaussians(path: str, gaussians: Gaussians3D):
  """Save Gaussians3D (tensors on any device) to the standard 3DGS PLY
  layout."""
  pos = _numpy(gaussians.position)
  n = pos.shape[0]
  feature = _numpy(gaussians.feature)
  if feature.ndim == 2:
    feature = feature[:, :, None]
  b = feature.shape[2]

  rot = _numpy(gaussians.rotation)
  rot_wxyz = np.concatenate([rot[:, 3:4], rot[:, 0:3]], 1)
  log_scaling = _numpy(gaussians.log_scaling)

  props = {
      "x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2],
      "nx": np.zeros(n, np.float32), "ny": np.zeros(n, np.float32),
      "nz": np.zeros(n, np.float32),
  }
  for i in range(3):
    props[f"f_dc_{i}"] = feature[:, i, 0]
  for j in range(b - 1):
    for i in range(3):
      props[f"f_rest_{i * (b - 1) + j}"] = feature[:, i, j + 1]
  props["opacity"] = _numpy(gaussians.alpha_logit)[:, 0]
  for i in range(3):
    props[f"scale_{i}"] = log_scaling[:, i]
  for i in range(4):
    props[f"rot_{i}"] = rot_wxyz[:, i]

  write_ply_raw(path, props)
