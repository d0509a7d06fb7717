"""Port vs reference: ``ParameterClass`` and ``check_finite``.

The same numpy tensors, gradients and visibilities (seeded) go through
``tpu_splatting.optim.ParameterClass`` and the port's: create, two
optimizer steps, a boolean and an index selection, ``append_tensors``,
``set_learning_rate`` and another step.  The tensors and every optimizer
state leaf agree to 1e-6 absolute (the same elementwise f32 formulas;
visible weights stay >= 0.25, where an ulp of ``pow`` stays small, as
in the optimizer tests).  A save / load round trip is exact.
``count_nonfinite`` gives the reference's paths and counts on the same
containers.
"""

import dataclasses
from typing import NamedTuple

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from tpu_splatting import data_types as jdt  # noqa: E402
from tpu_splatting import optim as jopt  # noqa: E402
from tpu_splatting.utils import check_finite as jcf  # noqa: E402
from tpu_splatting_torch import data_types as tdt  # noqa: E402
from tpu_splatting_torch import optim as topt  # noqa: E402
from tpu_splatting_torch.utils import check_finite as tcf  # noqa: E402

N = 48


def groups(mod):
  return {
      "position": mod.GroupConfig(type="local_vector", lr=0.3),
      "log_scaling": mod.GroupConfig(type="scalar", lr=0.1),
      "feature": mod.GroupConfig(type="vector", lr=0.025),
  }


def arrays(rng, n=N):
  return {k: v.astype(np.float32) for k, v in {
      "position": rng.standard_normal((n, 2)) * 10,
      "log_scaling": rng.normal(0.5, 0.3, (n, 2)),
      "feature": rng.uniform(0, 1, (n, 3)),
      "depths": rng.uniform(0, 1, n)}.items()}


def step_inputs(rng, n):
  grads = {k: rng.standard_normal(s).astype(np.float32) for k, s in (
      ("position", (n, 2)), ("log_scaling", (n, 2)), ("feature", (n, 3)))}
  vis = np.where(rng.random(n) < 0.3, 0.0,
                 rng.uniform(0.25, 2.0, n)).astype(np.float32)
  basis = (np.eye(2) + 0.1 * rng.standard_normal((n, 2, 2))).astype(
      np.float32)
  return grads, vis, basis


def both_step(pj, pt, rng):
  n = len(pt)
  grads, vis, basis = step_inputs(rng, n)
  pj = pj.step({k: jnp.asarray(v) for k, v in grads.items()},
               jnp.asarray(vis), basis=jnp.asarray(basis))
  pt = pt.step({k: torch.from_numpy(v) for k, v in grads.items()},
               torch.from_numpy(vis), basis=torch.from_numpy(basis))
  return pj, pt


def state_leaves(state):
  """{path: array} of a FractionalState of either side."""
  out = {"total_weight": state.total_weight,
         "running_vis": state.running_vis}
  for g, d in state.groups.items():
    for k, v in d.items():
      out[f"{g}.{k}"] = v
  return {k: np.asarray(v) for k, v in out.items()}


def assert_same(pj, pt):
  assert len(pj) == len(pt) and pj.batch_size == pt.batch_size
  assert set(pj.keys()) == set(pt.keys())
  for k, v in pt.items():
    np.testing.assert_allclose(v.numpy(), np.asarray(pj[k]), rtol=0,
                               atol=1e-6, err_msg=k)
  sj, st = state_leaves(pj.opt_state), state_leaves(pt.opt_state)
  assert set(sj) == set(st)
  for k in sj:
    assert st[k].shape == sj[k].shape, k
    np.testing.assert_allclose(st[k], sj[k], rtol=0, atol=1e-6, err_msg=k)


def created(seed=0):
  a = arrays(np.random.default_rng(seed))
  kw = dict(vis_beta=0.8, vis_smooth=0.1)
  pj = jopt.ParameterClass.create({k: jnp.asarray(v) for k, v in a.items()},
                                  groups(jopt), **kw)
  pt = topt.ParameterClass.create({k: torch.from_numpy(v.copy())
                                   for k, v in a.items()}, groups(topt), **kw)
  return pj, pt


def test_create_and_accessors():
  pj, pt = created()
  assert_same(pj, pt)
  assert type(pt.optimizer).__name__ == "VisibilityAwareLaProp"
  assert list(pt.optimized_keys()) == list(pj.optimized_keys())
  assert pt.learning_rates == pj.learning_rates
  assert torch.equal(pt.position, pt["position"])
  assert pt.parameter_groups["position"].type == "local_vector"
  with pytest.raises(AttributeError):
    pt.not_a_tensor  # noqa: B018


def test_steps_selections_appends():
  """Steps, then a bool mask, then indices (repeats and reorder), then
  appended rows with zeroed state, then a new learning rate and a step:
  the reference at every stage."""
  rng = np.random.default_rng(1)
  pj, pt = created(1)
  for _ in range(2):
    pj, pt = both_step(pj, pt, rng)
  assert_same(pj, pt)

  mask = rng.random(N) < 0.6
  pj, pt = pj[jnp.asarray(mask)], pt[torch.from_numpy(mask)]
  assert_same(pj, pt)
  idx = rng.integers(0, len(pt), len(pt) + 5)
  pj, pt = pj[jnp.asarray(idx)], pt[torch.from_numpy(idx)]
  assert_same(pj, pt)

  new = arrays(rng, 7)
  pj = pj.append_tensors({k: jnp.asarray(v) for k, v in new.items()})
  pt = pt.append_tensors({k: torch.from_numpy(v) for k, v in new.items()})
  assert_same(pj, pt)
  for leaf in state_leaves(pt.opt_state).values():
    assert not np.any(leaf[-7:])

  pj = pj.set_learning_rate(position=0.05, feature=0.5)
  pt = pt.set_learning_rate(position=0.05, feature=0.5)
  assert pt.learning_rates == pj.learning_rates
  assert pt.optimizer.vis_beta == 0.8 and pt.optimizer.vis_smooth == 0.1
  pj, pt = both_step(pj, pt, rng)
  assert_same(pj, pt)


def test_append_another_parameter_class():
  pj, pt = created(2)
  rng = np.random.default_rng(2)
  pj, pt = both_step(pj, pt, rng)
  pj2, pt2 = pj.append(pj[jnp.arange(5)]), pt.append(pt[torch.arange(5)])
  assert_same(pj2, pt2)
  for leaf in state_leaves(pt2.opt_state).values():
    np.testing.assert_array_equal(leaf[-5:], leaf[:5])


def test_functional():
  """A step and a selection leave the original's tensors untouched."""
  _, pt = created(3)
  before = {k: v.clone() for k, v in pt.items()}
  rng = np.random.default_rng(3)
  grads, vis, basis = step_inputs(rng, N)
  pt.step({k: torch.from_numpy(v) for k, v in grads.items()},
          torch.from_numpy(vis), basis=torch.from_numpy(basis))
  pt[torch.arange(4)]
  for k, v in pt.items():
    assert torch.equal(v, before[k])


def test_save_load_round_trip(tmp_path):
  pj, pt = created(4)
  rng = np.random.default_rng(4)
  pj, pt = both_step(pj, pt, rng)
  path = tmp_path / "params.pkl"
  pt.save(str(path))
  back = topt.ParameterClass.load(str(path), device="cpu")
  assert type(back.optimizer) is type(pt.optimizer)
  assert back.optimizer.groups == pt.optimizer.groups
  assert back.optimizer.vis_beta == pt.optimizer.vis_beta
  for k, v in pt.items():
    assert torch.equal(back[k], v)
  a, b = state_leaves(pt.opt_state), state_leaves(back.opt_state)
  for k in a:
    np.testing.assert_array_equal(a[k], b[k])
  pj_back, pt_back = both_step(pj, back, np.random.default_rng(5))
  assert_same(pj_back, pt_back)


class Pair(NamedTuple):
  a: object
  b: object


def nan_tree(lib, array):
  """The same nested containers of arrays (``array``: numpy -> the
  side's array) with NaN and inf in some leaves."""
  nan, inf = np.nan, np.inf
  g = lib.Gaussians2D(
      position=array(np.array([[nan, 1.0]], np.float32)),
      depths=array(np.zeros(1, np.float32)),
      log_scaling=array(np.zeros((1, 2), np.float32)),
      rotation=array(np.zeros((1, 2), np.float32)),
      alpha_logit=array(np.array([[inf]], np.float32)),
      feature=array(np.zeros((1, 3), np.float32)))
  return {"x": array(np.array([nan, 1.0], np.float32)),
          "l": [array(np.array([inf], np.float32)),
                (array(np.ones(1, np.float32)),
                 array(np.array([nan, -inf], np.float32)))],
          "nt": Pair(array(np.array([nan], np.float32)),
                     array(np.array([1, 2], np.int32))),
          "g": g, "n": None, "i": 3,
          "w": array(np.zeros((2, 2), np.float32))}


def test_count_nonfinite_matches_reference():
  want = jcf.count_nonfinite(nan_tree(jdt, jnp.asarray))
  got = tcf.count_nonfinite(nan_tree(tdt, torch.from_numpy))
  assert got == want
  assert list(got) == list(want)    # the reference's order too
  assert tcf.count_nonfinite({"ok": torch.ones(3)}) == {}
  assert tcf.count_nonfinite(torch.tensor([np.nan])) == {"": 1}


def test_check_finite_raises_with_paths():
  with pytest.raises(ValueError, match=r"non-finite values in params: "
                     r"\['g'\]\.position: 1"):
    tcf.check_finite(nan_tree(tdt, torch.from_numpy), "params")
  tcf.check_finite({"a": torch.ones(2), "s": dataclasses.replace(
      created()[1].opt_state)}, "state")
