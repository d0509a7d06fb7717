"""Port vs reference: transforms, 2D gaussian math and the SH basis, f64."""

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from tpu_splatting.lib import gaussian2d as jg2d  # noqa: E402
from tpu_splatting.lib import sh as jsh  # noqa: E402
from tpu_splatting.lib import transforms as jtf  # noqa: E402
from tpu_splatting_torch.lib import gaussian2d as tg2d  # noqa: E402
from tpu_splatting_torch.lib import sh as tsh  # noqa: E402
from tpu_splatting_torch.lib import transforms as ttf  # noqa: E402

RTOL = 1e-10   # f64 on both sides: the same formulas


def both(fn_j, fn_t, *arrays):
  out_j = fn_j(*[jnp.asarray(a, jnp.float64) for a in arrays])
  out_t = fn_t(*[torch.tensor(a, dtype=torch.float64) for a in arrays])
  if not isinstance(out_j, tuple):
    out_j, out_t = (out_j,), (out_t,)
  for a, b in zip(out_j, out_t):
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL,
                               atol=1e-12)


@pytest.mark.parametrize("name", [
    "quat_to_mat", "scaled_quat_to_mat", "quat_mul", "quat_conj",
    "normalize", "join_rt", "transform_points", "sigmoid",
    "inverse_sigmoid"])
def test_transforms(name):
  rng = np.random.default_rng(0)
  q = rng.standard_normal((5, 4))
  args = {
      "quat_to_mat": (q / np.linalg.norm(q, axis=-1, keepdims=True),),
      "scaled_quat_to_mat": (q, rng.random((5, 3)) + 0.1),
      "quat_mul": (q, rng.standard_normal((5, 4))),
      "quat_conj": (q,),
      "normalize": (np.concatenate([q, np.zeros((1, 4))]),),
      "join_rt": (rng.standard_normal((5, 3, 3)), rng.standard_normal((5, 3))),
      "transform_points": (rng.standard_normal((4, 4)),
                           rng.standard_normal((7, 3))),
      "sigmoid": (rng.standard_normal(9) * 4,),
      "inverse_sigmoid": (rng.random(9) * 0.98 + 0.01,),
  }[name]
  both(getattr(jtf, name), getattr(ttf, name), *args)


@pytest.mark.parametrize("name", [
    "pack_unpack", "perp", "eig2x2", "ellipse_bounds", "gaussian_scale",
    "inverse_cov", "cov_from_g2d", "conic_pdf", "gaussian_pdf",
    "gaussian_pdf_antialias"])
def test_gaussian2d(name):
  rng = np.random.default_rng(1)
  n = 11
  mean = rng.random((n, 2)) * 32
  ang = rng.uniform(0, np.pi, n)
  axis = np.stack([np.cos(ang), np.sin(ang)], -1)
  sigma = rng.random((n, 2)) * 3 + 0.2
  alpha = rng.random(n) * 0.9 + 0.05
  xy = rng.random((n, 2)) * 32
  a = rng.random(n) + 1.0
  cov = np.stack([a, rng.random(n) * 0.5, a + rng.random(n)], -1)
  cov[0] = [2.0, 0.0, 2.0]                  # isotropic fallback branch
  if name == "pack_unpack":
    both(lambda *x: jg2d.unpack_g2d(jg2d.pack_g2d(*x)),
         lambda *x: tg2d.unpack_g2d(tg2d.pack_g2d(*x)),
         mean, axis, sigma, alpha)
  elif name == "perp":
    both(jg2d.perp, tg2d.perp, axis)
  elif name in ("eig2x2", "inverse_cov"):
    both(getattr(jg2d, name), getattr(tg2d, name), cov)
  elif name == "ellipse_bounds":
    both(jg2d.ellipse_bounds, tg2d.ellipse_bounds, mean, axis * 3,
         axis[:, ::-1] * 2)
  elif name == "gaussian_scale":
    both(lambda x: jg2d.gaussian_scale(x, 1 / 255.),
         lambda x: tg2d.gaussian_scale(x, 1 / 255.),
         np.concatenate([alpha, [0.001, 0.0]]))
  elif name == "cov_from_g2d":
    both(jg2d.cov_from_g2d, tg2d.cov_from_g2d, axis, sigma)
  elif name == "conic_pdf":
    both(jg2d.conic_pdf, tg2d.conic_pdf, xy, mean, cov * 0.1)
  else:
    both(getattr(jg2d, name), getattr(tg2d, name), xy, mean, axis, sigma)


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_rsh_cart(degree):
  rng = np.random.default_rng(degree)
  d = rng.standard_normal((13, 3))
  d /= np.linalg.norm(d, axis=-1, keepdims=True)
  both(lambda x: jsh.rsh_cart(x, degree), lambda x: tsh.rsh_cart(x, degree),
       d)
  feats = np.zeros((2, 3, (degree + 1) ** 2))
  assert tsh.check_sh_degree(torch.tensor(feats)) == jsh.check_sh_degree(
      jnp.asarray(feats)) == degree
