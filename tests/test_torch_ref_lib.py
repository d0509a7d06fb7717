"""Port vs reference: the ground-truth layer ``ref_lib`` and
``perspective.unproject_points``.

``reference_project`` and ``reference_sh``, values and gradients (the
camera's pose and intrinsics included), to 1e-10 in f64 and, in f32, to
1e-3 of each leaf's largest magnitude (F8: f32 conditioning of the
projection, wrong on neither side); ``unproject_points`` and the
projection -> unprojection round trip.
"""

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from random_data import random_3d_gaussians, random_camera  # noqa: E402
from tpu_splatting import ref_lib as jref  # noqa: E402
from tpu_splatting.perspective import projection as jproj  # noqa: E402
import tpu_splatting_torch.ref_lib as tref  # noqa: E402
from tpu_splatting_torch import perspective as tpersp  # noqa: E402
from tpu_splatting_torch.rasterizer import reference as traster  # noqa: E402

PROJ_INPUTS = ("position", "log_scaling", "rotation", "alpha_logit",
               "T_camera_world", "projection")


def projection_case(dtype, seed=0, n=64):
  rng = np.random.default_rng(seed)
  jdt = jnp.float64 if dtype == np.float64 else jnp.float32
  camera = random_camera(rng, image_size=(320, 240), dtype=jdt)
  g = random_3d_gaussians(rng, n, camera, dtype=jdt)
  inputs = {name: np.asarray(getattr(g, name)) for name in PROJ_INPUTS[:4]}
  inputs["T_camera_world"] = np.asarray(camera.T_camera_world)
  inputs["projection"] = np.asarray(camera.projection)
  w_packed = rng.standard_normal((n, 7)).astype(dtype)
  w_z = rng.standard_normal(n).astype(dtype)
  return inputs, camera.image_size, w_packed, w_z


def compare(got, want, f64, scale_of=None):
  """f64: 1e-10 relative to the largest magnitude; f32: 1e-3 of it."""
  scale = max(float(np.abs(want).max()), 1e-30)
  tol = (1e-10 if f64 else 1e-3) * scale
  np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=scale_of)


def project_both(inputs, image_size, w_packed, w_z):
  """Both sides' (packed, z, gradients of a weighted sum of both outputs
  with respect to every input)."""
  def loss_j(*args):
    packed, z = jref.reference_project(*args, image_size)
    return jnp.sum(packed * w_packed) + jnp.sum(z * w_z)
  jargs = [jnp.asarray(inputs[k]) for k in PROJ_INPUTS]
  packed_j, z_j = jax.jit(jref.reference_project, static_argnums=6)(
      *jargs, image_size)
  grads_j = jax.jit(jax.grad(loss_j, argnums=tuple(range(6))))(*jargs)

  targs = [torch.from_numpy(inputs[k].copy()).requires_grad_()
           for k in PROJ_INPUTS]
  packed_t, z_t = tref.reference_project(*targs, image_size)
  assert packed_t.dtype == targs[0].dtype
  ((packed_t * torch.from_numpy(w_packed)).sum()
   + (z_t * torch.from_numpy(w_z)).sum()).backward()
  return ((packed_t.detach().numpy(), z_t.detach().numpy(),
           [a.grad.numpy() for a in targs]),
          (np.asarray(packed_j), np.asarray(z_j),
           [np.asarray(g) for g in grads_j]))


def assert_projections_equal(got, want, f64, grad_tol=None):
  compare(got[0], want[0], f64, "packed")
  compare(got[1], want[1], f64, "z")
  for name, a, g in zip(PROJ_INPUTS, got[2], want[2]):
    if grad_tol is None:
      compare(a, g, f64, name)
    else:
      np.testing.assert_allclose(a, g, rtol=0,
                                 atol=grad_tol * float(np.abs(g).max()),
                                 err_msg=name)
  # the pose and the intrinsics get gradients
  assert float(np.abs(got[2][4]).max()) > 0
  assert float(np.abs(got[2][5]).max()) > 0


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_reference_project_values_and_gradients(dtype):
  """Values to 1e-10 (f64) or 1e-3 (f32) of their scale, all splats.
  Gradients to 1e-10 (f64) or 1e-3 (f32) of each leaf's scale over the
  splats whose major axis ``v1 = (a - lambda2, b) / norm`` does not
  cancel (|v1x| >= 1e-3 in f64).  This scene has one splat with
  |v1x| = 3.1e-6 (F8): the two packages round ``exp``, the divisions and
  the batched matmuls by an ulp apart, and its ``a - lambda2``
  cancellation amplifies that (by how much depends on XLA:CPU's backend
  optimization level), so over all splats f64 gradients hold to 1e-6 of
  their scale, and in f32 that splat's gradients keep no digits (checked
  only in the subset's run)."""
  inputs, image_size, w_packed, w_z = projection_case(dtype)
  f64 = dtype == np.float64
  got, want = project_both(inputs, image_size, w_packed, w_z)
  compare(got[0], want[0], f64, "packed")
  compare(got[1], want[1], f64, "z")
  if f64:
    assert_projections_equal(got, want, f64, grad_tol=1e-6)
  inputs64, _, _, _ = projection_case(np.float64)   # the same draws
  axis_x = np.asarray(jax.jit(jref.reference_project, static_argnums=6)(
      *[jnp.asarray(inputs64[k]) for k in PROJ_INPUTS], image_size)[0][:, 2])
  keep = np.abs(axis_x) >= 1e-3
  assert int((~keep).sum()) == 1, np.abs(axis_x).min()
  sub = {k: (v[keep] if k in PROJ_INPUTS[:4] else v)
         for k, v in inputs.items()}
  got, want = project_both(sub, image_size, w_packed[keep], w_z[keep])
  assert_projections_equal(got, want, f64)


def test_eig2x2_agrees_on_one_covariance(monkeypatch):
  """F8's f64 drift is not in ``eig2x2``: fed the same covariances (the
  projection scene's, as the port's ``reference_project`` hands them to
  it, the cancelling splat included), both packages' ``eig2x2`` agree to
  1e-10 of scale in f64, values and gradients."""
  from tpu_splatting.lib import gaussian2d as jg2d
  from tpu_splatting_torch.lib import gaussian2d as tg2d
  inputs, image_size, _, _ = projection_case(np.float64)
  seen = []
  eig2x2 = tg2d.eig2x2
  monkeypatch.setattr(tg2d, "eig2x2", lambda c: seen.append(c) or eig2x2(c))
  tref.reference_project(*[torch.from_numpy(inputs[k].copy())
                           for k in PROJ_INPUTS], image_size)
  cov = seen[0].numpy()
  w = np.random.default_rng(3).standard_normal((cov.shape[0], 6))

  def loss_j(c):
    return jnp.sum(jnp.concatenate(jg2d.eig2x2(c), -1) * w)
  want = [np.asarray(x) for x in jg2d.eig2x2(jnp.asarray(cov))]
  want_grad = np.asarray(jax.grad(loss_j)(jnp.asarray(cov)))
  tc = torch.from_numpy(cov.copy()).requires_grad_()
  got = eig2x2(tc)
  (torch.cat(got, -1) * torch.from_numpy(w)).sum().backward()
  assert float(got[1][:, 0].abs().min()) < 1e-5     # the cancelling splat
  for name, a, b in zip(("sigma", "v1", "v2"), got, want):
    compare(a.detach().numpy(), b, True, name)
  compare(tc.grad.numpy(), want_grad, True, "grad")


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("degree", [0, 1, 3])
def test_reference_sh_values_and_gradients(dtype, degree):
  rng = np.random.default_rng(degree)
  n, k = 80, 3
  params = rng.standard_normal((n, k, (degree + 1) ** 2)).astype(dtype) * 0.3
  positions = rng.standard_normal((n, 3)).astype(dtype) * 4.0
  camera_pos = rng.standard_normal(3).astype(dtype)
  weight = rng.standard_normal((n, k)).astype(dtype)
  f64 = dtype == np.float64

  def loss_j(p, x, c):
    return jnp.sum(jref.reference_sh(p, x, c) * weight)
  jargs = [jnp.asarray(a) for a in (params, positions, camera_pos)]
  want = np.asarray(jref.reference_sh(*jargs))
  grads = jax.grad(loss_j, argnums=(0, 1, 2))(*jargs)

  targs = [torch.from_numpy(a.copy()).requires_grad_()
           for a in (params, positions, camera_pos)]
  got = tref.reference_sh(*targs)
  (got * torch.from_numpy(weight)).sum().backward()
  compare(got.detach().numpy(), want, f64, "sh")
  for name, a, g in zip(("params", "positions", "camera_pos"), targs, grads):
    # degree 0 does not depend on the direction: no gradient reaches the
    # positions (torch leaves it None, JAX gives zeros)
    got_grad = (torch.zeros_like(a) if a.grad is None else a.grad).numpy()
    compare(got_grad, np.asarray(g), f64, name)


def test_rasterize_reference_is_the_port_oracle():
  assert tref.rasterize_reference is traster.rasterize_reference
  assert tref.__all__ == jref.__all__


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_unproject_points(dtype):
  """uv + depth (N, 1) or (N,) -> world points, against the reference."""
  rng = np.random.default_rng(7)
  jdt = jnp.float64 if dtype == np.float64 else jnp.float32
  camera = random_camera(rng, image_size=(200, 100), dtype=jdt)
  t_image_world = np.array(camera.T_image_world)
  uv = (rng.random((50, 2)) * [200, 100]).astype(dtype)
  depth = rng.uniform(0.5, 20.0, (50, 1)).astype(dtype)
  f64 = dtype == np.float64
  for d in (depth, depth[:, 0]):
    want = np.asarray(jproj.unproject_points(
        jnp.asarray(uv), jnp.asarray(d), jnp.asarray(t_image_world)))
    got = tpersp.unproject_points(torch.from_numpy(uv), torch.from_numpy(d),
                                  torch.from_numpy(t_image_world))
    compare(got.numpy(), want, f64, "world")


def test_projection_unprojection_round_trip():
  """World points through the camera's T_image_world to (uv, depth), then
  ``unproject_points``: the points come back (f64)."""
  rng = np.random.default_rng(9)
  camera = random_camera(rng, image_size=(320, 240), dtype=jnp.float64)
  g = random_3d_gaussians(rng, 100, camera, dtype=jnp.float64)
  world = torch.from_numpy(np.asarray(g.position))
  t_image_world = torch.from_numpy(np.asarray(camera.T_image_world))
  h = torch.cat([world, torch.ones_like(world[:, :1])], -1) @ t_image_world.T
  depth = h[:, 2:3]
  uv = h[:, :2] / depth
  back = tpersp.unproject_points(uv, depth, t_image_world)
  np.testing.assert_allclose(back.numpy(), world.numpy(), rtol=1e-10,
                             atol=1e-10)
  # and through the reference projection: uv and z of reference_project
  packed, z = tref.reference_project(
      world, torch.from_numpy(np.asarray(g.log_scaling)),
      torch.from_numpy(np.asarray(g.rotation)),
      torch.from_numpy(np.asarray(g.alpha_logit)),
      torch.from_numpy(np.asarray(camera.T_camera_world)),
      torch.from_numpy(np.asarray(camera.projection)), camera.image_size)
  back = tpersp.unproject_points(packed[:, :2], z, t_image_world)
  np.testing.assert_allclose(back.numpy(), world.numpy(), rtol=1e-10,
                             atol=1e-10)
