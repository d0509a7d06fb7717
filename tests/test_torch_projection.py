"""Port vs reference: projection, NDC depth and SH shading, values (f32)
and gradients through autograd vs jax.grad (f64), pose and intrinsics
included."""

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import port_compare as pc  # noqa: E402
from random_data import random_3d_gaussians, random_camera  # noqa: E402
from tpu_splatting import RasterConfig  # noqa: E402
from tpu_splatting.perspective import projection as jproj  # noqa: E402
from tpu_splatting.spherical_harmonics import (  # noqa: E402
    evaluate_sh_at as jsh)
from tpu_splatting_torch.perspective import projection as tproj  # noqa: E402
from tpu_splatting_torch.spherical_harmonics import (  # noqa: E402
    evaluate_sh_at as tsh)

RTOL, ATOL = 1e-5, 1e-6        # f32 values
GRAD_RTOL, GRAD_ATOL = 1e-9, 1e-12   # f64 gradients: the same formulas


def scene(seed, n=64, dtype=jnp.float32):
  rng = np.random.default_rng(seed)
  camera = random_camera(rng, image_size=(64, 48), dtype=dtype)
  g = random_3d_gaussians(rng, n, camera, scale_factor=1.0, dtype=dtype)
  # a few points behind the camera / outside the view: the cull path
  pos = np.array(g.position)
  pos[:3] = -pos[:3] * 5
  g = g.replace(position=jnp.asarray(pos, dtype))
  sh = rng.standard_normal((n, 3, 16)) * 0.3
  return g.replace(feature=jnp.asarray(sh, dtype)), camera


def cast(g, camera, dtype):
  g = g.replace(**{k: jnp.asarray(v, dtype) for k, v in vars(g).items()})
  return g, camera.replace(projection=jnp.asarray(camera.projection, dtype),
                           T_camera_world=jnp.asarray(camera.T_camera_world,
                                                      dtype))


@pytest.mark.parametrize("seed", [0, 1])
def test_project_to_image(seed):
  """f64: every entry to 1e-10 (+1e-9 absolute).  f32: RTOL/ATOL on the
  entries the f32 reference itself gets right to 1e-6 (f32 rounding is
  amplified where the eigenvector of a near-diagonal covariance or a uv
  near 0 comes from a cancellation; those entries differ between any two
  f32 evaluations)."""
  g, camera = scene(seed)
  config = RasterConfig()
  pj, dj, vj = jproj.project_to_image(g, camera, config)
  pt, dt, vt = tproj.project_to_image(pc.gaussians(g), pc.camera(camera),
                                      pc.config(config))
  assert pt.dtype == torch.float32
  np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
  assert 0 < int(vt.sum()) < len(vt)

  g64, cam64 = cast(g, camera, jnp.float64)
  pj64, dj64, _ = jproj.project_to_image(g64, cam64, config)
  pt64, dt64, _ = tproj.project_to_image(pc.gaussians(g64), pc.camera(cam64),
                                         pc.config(config))
  # atol: entries that cancel to ~1e-6 of inputs of ~50 keep ~1e-11
  np.testing.assert_allclose(pt64.numpy(), np.asarray(pj64), rtol=1e-10,
                             atol=1e-9)
  np.testing.assert_allclose(dt64.numpy(), np.asarray(dj64), rtol=1e-10,
                             atol=1e-9)
  for got, want, want64 in ((pt, pj, pj64), (dt, dj, dj64)):
    want, want64 = np.asarray(want), np.asarray(want64)
    ok = np.isclose(want, want64, rtol=1e-6, atol=1e-7)
    assert ok.mean() > 0.95
    np.testing.assert_allclose(got.numpy()[ok], want[ok], rtol=RTOL,
                               atol=ATOL)
  nj = jnp.where(dj > 0, jproj.ndc_depth(dj, camera.near_plane,
                                         camera.far_plane), 0.0)
  nt = torch.where(dt > 0, tproj.ndc_depth(dt, camera.near_plane,
                                           camera.far_plane), 0.0)
  np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=RTOL, atol=ATOL)
  np.testing.assert_allclose(
      tproj.inverse_ndc_depth(nt[vt], 0.1, 100.0).numpy(),
      np.asarray(jproj.inverse_ndc_depth(nj[vj], 0.1, 100.0)),
      rtol=RTOL, atol=ATOL)


def test_evaluate_sh_at():
  g, camera = scene(2)
  fj = jsh(g.feature, g.position, camera.camera_position)
  tc = pc.camera(camera)
  ft = tsh(pc.t(g.feature), pc.t(g.position), tc.camera_position)
  assert ft.dtype == torch.float32
  np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=RTOL,
                             atol=ATOL)


def test_gradients_match_jax():
  """d(loss)/d(gaussians, SH, intrinsics, pose) through projection + SH."""
  g, camera = scene(3, dtype=jnp.float64)
  config = RasterConfig()
  rng = np.random.default_rng(4)
  w_pts = rng.standard_normal((64, 7))
  w_dep = rng.standard_normal((64, 1))
  w_rgb = rng.standard_normal((64, 3))

  def loss_j(pos, ls, rot, al, sh, proj, pose):
    cam = camera.replace(projection=proj, T_camera_world=pose)
    gg = g.replace(position=pos, log_scaling=ls, rotation=rot,
                   alpha_logit=al, feature=sh)
    p, d, _ = jproj.project_to_image(gg, cam, config)
    rgb = jsh(sh, pos, cam.camera_position)
    return (jnp.sum(p * w_pts) + jnp.sum(d * w_dep) + jnp.sum(rgb * w_rgb))

  args = (g.position, g.log_scaling, g.rotation, g.alpha_logit, g.feature,
          camera.projection, camera.T_camera_world)
  args = tuple(jnp.asarray(a, jnp.float64) for a in args)
  gj = jax.grad(loss_j, argnums=tuple(range(7)))(*args)

  targs = [pc.t(a, torch.float64).requires_grad_(True) for a in args]
  pos, ls, rot, al, sh, proj, pose = targs
  tc = pc.camera(camera).replace(projection=proj, T_camera_world=pose)
  tg = pc.gaussians(g).replace(position=pos, log_scaling=ls, rotation=rot,
                               alpha_logit=al, feature=sh)
  p, d, _ = tproj.project_to_image(tg, tc, pc.config(config))
  rgb = tsh(sh, pos, tc.camera_position)
  loss = ((p * torch.from_numpy(w_pts)).sum()
          + (d * torch.from_numpy(w_dep)).sum()
          + (rgb * torch.from_numpy(w_rgb)).sum())
  loss.backward()
  for name, a, b in zip(("position", "log_scaling", "rotation",
                         "alpha_logit", "sh", "projection", "pose"),
                        gj, targs):
    assert b.grad is not None, name
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(a),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=name)
  assert float(np.abs(np.asarray(gj[5])).max()) > 0
  assert float(np.abs(np.asarray(gj[6])).max()) > 0
