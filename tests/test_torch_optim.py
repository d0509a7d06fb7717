"""Port vs reference: the fractional optimizers.

The same parameters, gradients and visibility weights (numpy, seeded) go
through ``tpu_splatting.optim`` and ``tpu_splatting_torch.optim`` for three
steps; parameters and every state tensor must agree to atol 1e-6 plus
rtol 1e-5 (f32, the same elementwise formulas).  XLA's and torch's ``pow``
differ by an ulp, and ``1 - beta ** w`` cancels for small w on both
sides: at w ~ 0.15 (a visibility-aware weight) that ulp becomes ~1e-5
of the moment.  Visible weights stay >= 0.25 for the same reason.
"""

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from tpu_splatting import optim as jopt  # noqa: E402
from tpu_splatting_torch import optim as topt  # noqa: E402

N = 64
OPTIMIZERS = ["FractionalAdam", "FractionalLaProp", "SparseAdam",
              "SparseLaProp", "VisibilityAwareAdam", "VisibilityAwareLaProp"]


def groups(mod):
  return {
      "position": mod.GroupConfig(type="local_vector", lr=0.01),
      "feature": mod.GroupConfig(lr=0.005, betas=(0.8, 0.99), clip=2.0),
      "alpha": mod.GroupConfig(type="vector", lr=0.1,
                               bias_correction=False),
  }


def inputs(rng):
  params = {"position": rng.standard_normal((N, 3)),
            "feature": rng.standard_normal((N, 3, 4)),
            "alpha": rng.standard_normal((N, 1))}
  return {k: v.astype(np.float32) for k, v in params.items()}


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_three_steps_match_reference(name):
  rng = np.random.default_rng(3)
  params = inputs(rng)
  basis = (np.eye(3) + 0.1 * rng.standard_normal((N, 3, 3))).astype(
      np.float32)
  jo = getattr(jopt, name)(groups(jopt))
  to = getattr(topt, name)(groups(topt))
  pj = {k: jnp.asarray(v) for k, v in params.items()}
  pt = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
  sj, st = jo.init(pj), to.init(pt)
  for _ in range(3):
    grads = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
    vis = np.where(rng.random(N) < 0.3, 0.0,
                   rng.uniform(0.25, 2.0, N)).astype(np.float32)
    if name.startswith("Sparse"):
      wj, wt = jnp.asarray(vis > 0), torch.from_numpy(vis > 0)
    else:
      wj, wt = jnp.asarray(vis), torch.from_numpy(vis)
    pj, sj = jo.step(pj, {k: jnp.asarray(v) for k, v in grads.items()}, sj,
                     wj, basis=jnp.asarray(basis))
    pt, st = to.step(pt, {k: torch.from_numpy(v) for k, v in grads.items()},
                     st, wt, basis=torch.from_numpy(basis))
  for k in params:
    np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), atol=1e-6,
                               rtol=1e-5, err_msg=k)
    assert not np.allclose(pt[k].numpy(), params[k]), k
    for key in ("m", "v"):
      np.testing.assert_allclose(st.groups[k][key].numpy(),
                                 np.asarray(sj.groups[k][key]), atol=1e-6,
                                 rtol=1e-5, err_msg=f"{k}.{key}")
  np.testing.assert_allclose(st.total_weight.numpy(),
                             np.asarray(sj.total_weight), atol=1e-6,
                             rtol=1e-5)
  np.testing.assert_allclose(st.running_vis.numpy(),
                             np.asarray(sj.running_vis), atol=1e-6,
                             rtol=1e-5)


def test_invisible_points_untouched():
  rng = np.random.default_rng(4)
  params = {k: torch.from_numpy(v) for k, v in inputs(rng).items()}
  opt = topt.FractionalAdam(groups(topt))
  state = opt.init(params)
  grads = {k: torch.randn(v.shape) for k, v in params.items()}
  weight = torch.zeros(N)
  weight[::2] = 1.0
  new, state = opt.step(params, grads, state, weight,
                        basis=torch.eye(3).expand(N, 3, 3))
  for k in params:
    torch.testing.assert_close(new[k][1::2], params[k][1::2], atol=0,
                               rtol=0)
    assert not torch.equal(new[k][::2], params[k][::2])
    assert not bool(state.groups[k]["m"][1::2].any())
