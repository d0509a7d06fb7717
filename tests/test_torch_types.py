"""Port vs reference: the methods of the exported types.

``Gaussians3D``, ``Gaussians2D``, ``mat_to_quat``,
``CameraParams.scale_image`` and ``RenderedPoints.visible_mask`` /
``gaussian_scale`` on the same numpy inputs from a seed, in f32 (1e-6
relative, with an absolute floor of 1e-6 times the field's largest
magnitude for entries that cancel towards 0) and in f64 (1e-12);
``batch_size``, ``image_size`` and the masks exactly.  ``mat_to_quat`` is
also taken down each of its four pivot branches.
"""

import math

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from tpu_splatting import data_types as jdt  # noqa: E402
from tpu_splatting import rendering as jrendering  # noqa: E402
from tpu_splatting.perspective import params as jparams  # noqa: E402
from tpu_splatting_torch import data_types as tdt  # noqa: E402
from tpu_splatting_torch import rendering as trendering  # noqa: E402
from tpu_splatting_torch.lib import transforms as ttf  # noqa: E402
from tpu_splatting_torch.perspective import params as tparams  # noqa: E402

N = 64
RTOL = {np.float32: 1e-6, np.float64: 1e-12}
DTYPES = [np.float32, np.float64]
G3_FIELDS = ("position", "log_scaling", "rotation", "alpha_logit", "feature")
G2_FIELDS = ("position", "depths", "log_scaling", "rotation", "alpha_logit",
             "feature")


def close(got, want, dtype):
  got, want = np.asarray(got), np.asarray(want)
  assert got.dtype == want.dtype and got.shape == want.shape
  rtol = RTOL[dtype]
  np.testing.assert_allclose(
      got, want, rtol=rtol, atol=rtol * max(float(np.abs(want).max()), 1.0))


def g3_arrays(dtype, seed=0, n=N):
  rng = np.random.default_rng(seed)
  return {k: v.astype(dtype) for k, v in {
          "position": rng.standard_normal((n, 3)) * 3,
          "log_scaling": rng.normal(-2, 0.5, (n, 3)),
          "rotation": rng.standard_normal((n, 4)),
          "alpha_logit": rng.standard_normal((n, 1)),
          "feature": rng.standard_normal((n, 3, 4))}.items()}


def both_g3(arrays):
  return (jdt.Gaussians3D(**{k: jnp.asarray(v) for k, v in arrays.items()}),
          tdt.Gaussians3D(**{k: torch.from_numpy(v.copy())
                             for k, v in arrays.items()}))


def assert_g3_close(gt, gj, dtype, fields=G3_FIELDS):
  for f in fields:
    close(getattr(gt, f).numpy(), getattr(gj, f), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_packed_round_trip(dtype):
  gj, gt = both_g3(g3_arrays(dtype))
  assert gt.batch_size == gj.batch_size == (N,)
  pt = gt.packed()
  assert pt.shape == (N, 11)
  np.testing.assert_array_equal(pt.numpy(), np.asarray(gj.packed()))
  back = tdt.Gaussians3D.from_packed(pt, gt.feature)
  for f in G3_FIELDS:
    assert torch.equal(getattr(back, f), getattr(gt, f)), f
  back_j = jdt.Gaussians3D.from_packed(gj.packed(), gj.feature)
  assert_g3_close(back, back_j, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_scale_and_alpha(dtype):
  gj, gt = both_g3(g3_arrays(dtype, seed=1))
  close(gt.scale.numpy(), gj.scale, dtype)
  close(gt.alpha.numpy(), gj.alpha, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [0.5, 3.0])
def test_scaled(dtype, s):
  gj, gt = both_g3(g3_arrays(dtype, seed=2))
  got, want = gt.scaled(s), gj.scaled(s)
  assert_g3_close(got, want, dtype)
  np.testing.assert_array_equal(
      got.log_scaling.numpy(), gt.log_scaling.numpy() + dtype(math.log(s)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_translated(dtype):
  gj, gt = both_g3(g3_arrays(dtype, seed=3))
  shift = np.random.default_rng(30).standard_normal(3).astype(dtype)
  assert_g3_close(gt.translated(torch.from_numpy(shift)),
                  gj.translated(jnp.asarray(shift)), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_concat(dtype):
  parts = [g3_arrays(dtype, seed=s, n=n) for s, n in ((4, N), (5, 7), (6, 1))]
  got = tdt.Gaussians3D.concat([both_g3(a)[1] for a in parts])
  want = jdt.Gaussians3D.concat([both_g3(a)[0] for a in parts])
  assert got.batch_size == want.batch_size == (N + 8,)
  for f in G3_FIELDS:
    np.testing.assert_array_equal(getattr(got, f).numpy(),
                                  np.asarray(getattr(want, f)))


def random_rotation(rng):
  q = rng.standard_normal(4)
  return ttf.quat_to_mat(torch.from_numpy(q / np.linalg.norm(q))).numpy()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transform_rigid(dtype, seed):
  rng = np.random.default_rng(40 + seed)
  m44 = np.eye(4)
  m44[:3, :3] = random_rotation(rng)
  m44[:3, 3] = rng.standard_normal(3) * 2
  m44 = m44.astype(dtype)
  gj, gt = both_g3(g3_arrays(dtype, seed=7 + seed))
  got = gt.transform_rigid(torch.from_numpy(m44))
  want = gj.transform_rigid(jnp.asarray(m44))
  assert_g3_close(got, want, dtype)


def mat_to_quat_both(r):
  got = tdt.mat_to_quat(torch.from_numpy(r)).numpy()
  want = np.asarray(jdt.mat_to_quat(jnp.asarray(r)))
  return got, want


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", range(5))
def test_mat_to_quat_random(dtype, seed):
  r = random_rotation(np.random.default_rng(50 + seed)).astype(dtype)
  got, want = mat_to_quat_both(r)
  close(got, want, dtype)
  # and it is the rotation's quaternion
  close(ttf.quat_to_mat(torch.from_numpy(got)).numpy(), r, dtype)


# (rotation, the pivot of (trace, m00, m11, m22) that wins)
PIVOTS = {
    "identity": (np.eye(3), 0),
    "pi_about_x": (np.diag([1.0, -1.0, -1.0]), 1),
    "pi_about_y": (np.diag([-1.0, 1.0, -1.0]), 2),
    "pi_about_z": (np.diag([-1.0, -1.0, 1.0]), 3),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(PIVOTS))
def test_mat_to_quat_pivot_branches(dtype, case):
  r, pivot = PIVOTS[case]
  r = r.astype(dtype)
  assert int(np.argmax([np.trace(r), r[0, 0], r[1, 1], r[2, 2]])) == pivot
  got, want = mat_to_quat_both(r)
  close(got, want, dtype)
  # the unit quaternion along the pivot's axis (w for the trace)
  expect = np.zeros(4, dtype)
  expect[(pivot + 3) % 4] = 1.0
  np.testing.assert_array_equal(got, expect)


def g2_arrays(dtype, seed=8):
  rng = np.random.default_rng(seed)
  rot = rng.standard_normal((N, 2))
  return {k: v.astype(dtype) for k, v in {
      "position": rng.random((N, 2)) * 100,
      "depths": rng.random((N, 1)) * 10 + 0.1,
      "log_scaling": rng.normal(0.5, 0.5, (N, 2)),
      "rotation": rot / np.linalg.norm(rot, axis=1, keepdims=True),
      "alpha_logit": rng.standard_normal((N, 1)) * 2,
      "feature": rng.random((N, 3))}.items()}


@pytest.mark.parametrize("dtype", DTYPES)
def test_gaussians2d_methods(dtype):
  arrays = g2_arrays(dtype)
  gj = jdt.Gaussians2D(**{k: jnp.asarray(v) for k, v in arrays.items()})
  gt = tdt.Gaussians2D(**{k: torch.from_numpy(v.copy())
                          for k, v in arrays.items()})
  assert gt.batch_size == gj.batch_size == (N,)
  close(gt.opacity.numpy(), gj.opacity, dtype)
  close(gt.scaling.numpy(), gj.scaling, dtype)
  new = np.random.default_rng(80).random((N, 2)).astype(dtype) + 0.5
  got = gt.set_scaling(torch.from_numpy(new))
  want = gj.set_scaling(jnp.asarray(new))
  for f in G2_FIELDS:
    close(getattr(got, f).numpy(), getattr(want, f), dtype)


@pytest.mark.parametrize("scale", [0.5, 0.3])
def test_scale_image(scale):
  proj = np.asarray([1111.0, 997.0, 511.5, 383.25], np.float32)
  pose = np.eye(4, dtype=np.float32)
  kw = dict(near_plane=0.1, far_plane=100.0, image_size=(1023, 767))
  cj = jparams.CameraParams(projection=jnp.asarray(proj),
                            T_camera_world=jnp.asarray(pose), **kw)
  ct = tparams.CameraParams(projection=torch.from_numpy(proj),
                            T_camera_world=torch.from_numpy(pose), **kw)
  got, want = ct.scale_image(scale), cj.scale_image(scale)
  assert got.image_size == want.image_size == (int(1023 * scale),
                                               int(767 * scale))
  close(got.projection.numpy(), want.projection, np.float32)
  assert got.near_plane == want.near_plane and got.far_plane == want.far_plane
  assert torch.equal(got.T_camera_world, ct.T_camera_world)


def rendered_points(dtype):
  """A hand-built RenderedPoints on both sides: opacities across the alpha
  threshold, at 0, and at 1; some visibilities exactly 0."""
  rng = np.random.default_rng(9)
  g2d = rng.random((N, 7))
  g2d[:, 6] = np.concatenate([[0.0, 1.0, 1 / 255, 0.5 / 255],
                              rng.random(N - 4)])
  vis = np.where(rng.random(N) < 0.3, 0.0, rng.random(N))
  arrays = {"in_view": rng.random(N) < 0.8, "depths": rng.random((N, 1)),
            "gaussians2d": g2d.astype(dtype), "features": rng.random((N, 3)),
            "_visibility": vis.astype(dtype)}
  return (jrendering.RenderedPoints(**{k: jnp.asarray(v)
                                       for k, v in arrays.items()}),
          trendering.RenderedPoints(**{k: torch.from_numpy(np.array(v))
                                       for k, v in arrays.items()}))


@pytest.mark.parametrize("dtype", DTYPES)
def test_rendered_points_methods(dtype):
  pj, pt = rendered_points(dtype)
  np.testing.assert_array_equal(pt.visible_mask.numpy(),
                                np.asarray(pj.visible_mask))
  assert 0 < int(pt.visible_mask.sum()) < N
  for threshold in (1 / 255, 0.1):
    got = pt.gaussian_scale(threshold).numpy()
    close(got, pj.gaussian_scale(threshold), dtype)
    assert got[0] == got[3] == 0.0 and np.all(np.isfinite(got))
  close(pt.gaussian_scale().numpy(), pj.gaussian_scale(), dtype)
