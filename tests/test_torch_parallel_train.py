"""Port vs reference: the data-parallel training step and the point-sharded
projection, each against the JAX package's own multi-device function on
virtual CPU devices.

* ``make_train_step``: one step on 2 shards, 4 cameras, stream and sorted
  pipelines, in f64 on both sides: the loss to rtol 1e-10, and every
  updated tensor and optimizer state tensor to atol 1e-10 / rtol 1e-8.
  The updated tensors hold the gradients that flow back through the
  shards' copies (the reference's psum'd gradients) and the visibility
  summed over the batch, so the update checks both.  f64 because an f32
  LaProp first step maps a gradient to about lr * sign, which turns the
  f32 gradients' ~1e-3 relative agreement (ROADMAP F8) into whole steps.
* ``sharded_projection`` on 4 shards: f64 to rtol 1e-10 / atol 1e-9 (the
  projection tests' f64 tolerance), and the f32 in-view mask exactly.
"""

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

import port_compare as pc  # noqa: E402
from test_parallel import make_scene  # noqa: E402
from tpu_splatting import RasterConfig  # noqa: E402
from tpu_splatting.optim import GroupConfig as JGroupConfig  # noqa: E402
from tpu_splatting.parallel import data_parallel as jdp  # noqa: E402
from tpu_splatting_torch.optim import GroupConfig  # noqa: E402
from tpu_splatting_torch.parallel import data_parallel as tdp  # noqa: E402
from tpu_splatting_torch.parallel.mesh import make_mesh  # noqa: E402

FIELDS = ("position", "log_scaling", "rotation", "alpha_logit", "feature")


def f64_scene(n_points=256):
  gaussians, camera = make_scene(n_points=n_points)
  gaussians = jax.tree.map(lambda x: x.astype(jnp.float64), gaussians)
  camera = camera.replace(
      projection=camera.projection.astype(jnp.float64),
      T_camera_world=camera.T_camera_world.astype(jnp.float64))
  return gaussians, camera


def groups(config_cls):
  out = {k: config_cls(type="scalar", lr=0.05)
         for k in ("position", "log_scaling", "rotation", "alpha_logit")}
  out["feature"] = config_cls(type="vector", lr=0.05)
  return out


@pytest.mark.parametrize("pipeline", ["stream", "sorted"])
def test_train_step_matches_reference_train_step(pipeline):
  gaussians, camera = f64_scene()
  config = RasterConfig(tile_size=16, chunk_size=16, pipeline=pipeline)
  b, n_shards = 4, 2
  poses = np.tile(np.asarray(camera.T_camera_world), (b, 1, 1))
  poses[:, 0, 3] += 1e-3 * np.arange(b)
  projections = np.tile(np.asarray(camera.projection), (b, 1))
  w, h = camera.image_size
  targets = np.random.default_rng(2).random((b, h, w, 3))

  jmesh = JMesh(jax.devices("cpu")[:n_shards], ("data",))
  shard = NamedSharding(jmesh, P("data"))
  jstep, jopt = jdp.make_train_step(jmesh, camera, config,
                                    groups(JGroupConfig), max_overlaps=4096)
  jt = {k: getattr(gaussians, k) for k in FIELDS}
  want, wstate, wloss = jstep(
      jt, jopt.init(jt), *(jax.device_put(jnp.asarray(x), shard)
                           for x in (projections, poses, targets)))

  tstep, topt = tdp.make_train_step(
      make_mesh(n_shards, devices=["cpu"] * n_shards), pc.camera(camera),
      pc.config(config), groups(GroupConfig), max_overlaps=4096)
  tt = {k: pc.t(v) for k, v in jt.items()}
  got, gstate, gloss = tstep(tt, topt.init(tt), *(
      torch.from_numpy(x) for x in (projections, poses, targets)))

  assert got["position"].dtype == torch.float64
  np.testing.assert_allclose(float(gloss), float(wloss), rtol=1e-10)
  assert float(np.asarray(wstate.running_vis).max()) > 0.0
  for k in FIELDS:
    assert not np.allclose(np.asarray(want[k]), np.asarray(jt[k])), k
    np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                               atol=1e-10, rtol=1e-8, err_msg=k)
    for key in ("m", "v"):
      np.testing.assert_allclose(gstate.groups[k][key].numpy(),
                                 np.asarray(wstate.groups[k][key]),
                                 atol=1e-10, rtol=1e-8, err_msg=f"{k}.{key}")
  for key in ("total_weight", "running_vis"):
    np.testing.assert_allclose(getattr(gstate, key).numpy(),
                               np.asarray(getattr(wstate, key)), atol=1e-10,
                               rtol=1e-8, err_msg=key)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_sharded_projection_matches_reference(dtype):
  gaussians, camera = f64_scene()
  if dtype == "float32":
    gaussians, camera = make_scene(n_points=256)
  config = RasterConfig()
  n_shards = 4
  jmesh = JMesh(jax.devices("cpu")[:n_shards], ("data",))
  g_sharded = jax.device_put(gaussians, NamedSharding(jmesh, P("data")))
  pj, dj, vj = jax.jit(jdp.sharded_projection(jmesh, camera, config))(
      g_sharded)
  pt, dt, vt = tdp.sharded_projection(
      make_mesh(n_shards, devices=["cpu"] * n_shards), pc.camera(camera),
      pc.config(config))(pc.gaussians(gaussians))
  assert pt.dtype == getattr(torch, dtype) and pt.shape == (256, 7)
  np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
  assert 0 < int(vt.sum())
  if dtype == "float64":
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-10,
                               atol=1e-9)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-10,
                               atol=1e-9)
