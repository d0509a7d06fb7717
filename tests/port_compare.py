"""Helpers for the tests that hold tpu_splatting_torch against tpu_splatting.

Data crosses between the two packages as numpy arrays only: a JAX pytree
goes through ``jax.device_get`` into plain dicts, which the port's
``convert`` module turns into tensors.
"""

from __future__ import annotations

import contextlib
import dataclasses

import jax
import numpy as np
import torch
from jax._src import dispatch
from jax.experimental.pallas import tpu as pltpu

from tpu_splatting_torch import convert


@contextlib.contextmanager
def tpu_reference_mode():
  """A block of the benchmarks' Pallas TPU probes run by the reference
  itself, in TPU interpret mode with x64 off (ROADMAP F11), isolated from
  every other such block of the process (F21).

  Two states of the process outlive a probe that raises.  TPU interpret
  mode keeps its simulated memory in one object, left set by a kernel
  that raises (``pltpu.reset_tpu_interpret_mode_state``).  And its
  callbacks are ordered effects: JAX passes one token from each ordered
  computation of a thread to the next (``dispatch.runtime_tokens``).  A
  kernel that fails after its dispatch has returned (XLA runs it
  asynchronously when its inputs are not ready yet, as on a loaded
  machine) leaves a failed token there, and every later interpreted
  kernel of the thread then fails with "Buffer Definition Event:
  CpuCallback error".  So each block starts from a reset interpret state
  and an empty token set, and leaves them so."""
  pltpu.reset_tpu_interpret_mode_state()
  dispatch.runtime_tokens.clear()
  try:
    with pltpu.force_tpu_interpret_mode(), jax.enable_x64(False):
      yield
  finally:
    dispatch.runtime_tokens.clear()
    pltpu.reset_tpu_interpret_mode_state()


def fields(obj) -> dict:
  """Dataclass (pytree) -> {field: numpy array or plain value}."""
  out = {}
  for f in dataclasses.fields(obj):
    v = getattr(obj, f.name)
    out[f.name] = np.asarray(jax.device_get(v)) if hasattr(v, "shape") else v
  return out


def t(x, dtype=None) -> torch.Tensor:
  """numpy / JAX array -> CPU tensor (copy), optionally cast."""
  out = torch.from_numpy(np.array(jax.device_get(x), copy=True))
  return out if dtype is None else out.to(dtype)


def config(cfg):
  return convert.raster_config_from_dict(dataclasses.asdict(cfg))


def gaussians(g):
  return convert.gaussians3d_from_numpy(fields(g), device="cpu")


def camera(c):
  return convert.camera_from_numpy(fields(c), device="cpu")


def mapping(m):
  return convert.stream_mapping_from_numpy(fields(m), device="cpu")


def assert_mappings_equal(mj, mt):
  """Every integer field exactly, the table to 1e-7, static metadata."""
  for name in convert.MAPPING_INT_FIELDS:
    a = np.asarray(getattr(mj, name)).astype(np.int64)
    b = getattr(mt, name).numpy().astype(np.int64)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    np.testing.assert_array_equal(b, a, err_msg=name)
  np.testing.assert_allclose(mt.table.numpy(), np.asarray(mj.table),
                             rtol=0, atol=1e-7)
  for f in dataclasses.fields(mt):
    if not isinstance(getattr(mt, f.name), torch.Tensor):
      assert getattr(mt, f.name) == getattr(mj, f.name), f.name


def tile_mapping(m):
  return convert.tile_mapping_from_numpy(fields(m), device="cpu")


def assert_tile_mappings_equal(mj, mt):
  """A sorted-pipeline TileMapping: every integer field exactly, the
  sorted payload to 1e-7, the static metadata."""
  for name in convert.TILE_MAPPING_INT_FIELDS:
    a = np.asarray(getattr(mj, name)).astype(np.int64)
    b = getattr(mt, name).numpy().astype(np.int64)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    np.testing.assert_array_equal(b, a, err_msg=name)
  assert (mj.sorted_payload is None) == (mt.sorted_payload is None)
  if mt.sorted_payload is not None:
    np.testing.assert_allclose(mt.sorted_payload.numpy(),
                               np.asarray(mj.sorted_payload), rtol=0,
                               atol=1e-7)
  for f in dataclasses.fields(mt):
    if not isinstance(getattr(mt, f.name), torch.Tensor) and (
        f.name != "sorted_payload"):
      assert getattr(mt, f.name) == getattr(mj, f.name), f.name
