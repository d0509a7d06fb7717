"""Port vs reference: the fit-image trainer
(``tpu_splatting_torch.examples.fit_image_gaussians`` against
``examples/fit_image_gaussians.py``).

One ``train_step`` from the same tensors, optimizer state and calibrated
config: the loss within 1e-5, the new tensors, visibility and heuristics
within 1e-3 of each one's largest magnitude (f32 projection
conditioning, ROADMAP F8).  Then the port's ``main`` on the CPU at
``tests/test_fit_image.py``'s configurations and PSNR floors: the fast
one here, the converge and antialias ones in the slow tier, as the
reference marks them.
"""

import sys
from pathlib import Path

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).parent.parent))

from examples import fit_image_gaussians as jfit  # noqa: E402
from tests import port_compare as pc  # noqa: E402
from tpu_splatting import RasterConfig as JRasterConfig  # noqa: E402
from tpu_splatting.data_types import Gaussians2D as JG2  # noqa: E402
from tpu_splatting.optim import ParameterClass as JPC  # noqa: E402
from tpu_splatting_torch.examples import fit_image_gaussians as tfit  # noqa: E402,E501
from tpu_splatting_torch.optim import ParameterClass as TPC  # noqa: E402

N, SIZE = 120, (48, 32)
FAST = ["--n", "120", "--iters", "10", "--epoch", "5", "--max_epoch", "5",
        "--image_size", "48,32", "--max_overlaps", "4096"]


def splat_arrays(seed=0, n=N):
  """The trainer's initial distribution, drawn with numpy."""
  rng = np.random.default_rng(seed)
  w, h = SIZE
  density = 0.5 * w / (1 + np.sqrt(n))
  rot = rng.standard_normal((n, 2))
  alpha = rng.uniform(0.5, 1.0, n)
  return {k: v.astype(np.float32) for k, v in {
      "position": rng.uniform(0, 1, (n, 2)) * [w, h],
      "depths": rng.uniform(0, 1, n),
      "log_scaling": np.log((rng.uniform(0, 1, (n, 2)) + 0.2) * density),
      "rotation": rot / np.linalg.norm(rot, axis=1, keepdims=True),
      "alpha_logit": np.log(alpha / (1 - alpha))[:, None],
      "feature": rng.uniform(0, 1, (n, 3))}.items()}


def scale_close(got, want, rel, label):
  want = np.asarray(want)
  got = np.asarray(got)
  assert got.shape == want.shape, label
  np.testing.assert_allclose(got, want, rtol=0, err_msg=label,
                             atol=rel * max(float(np.abs(want).max()), 1e-12))


@pytest.mark.parametrize("antialias", [False, True])
def test_train_step_matches_reference(antialias):
  a = splat_arrays(1)
  ref_image = np.array(jfit.load_image(jfit.parse_args(
      ["--image_size", "48,32"])), np.float32)
  kw = dict(vis_smooth=0.1, vis_beta=0.8)
  with jax.enable_x64(False):
    pj = JPC.create({k: jnp.asarray(v) for k, v in a.items()},
                    jfit.make_parameter_groups(0.5),
                    optimizer_cls=jfit.VisibilityAwareLaProp, **kw)
    cfg = jfit.autosize_stream_caps(JRasterConfig(
        compute_point_heuristic=True, compute_visibility=True,
        blur_cov=0.0 if antialias else 0.3, antialias=antialias), pj, SIZE)
    step_kw = dict(image_size=SIZE, max_overlaps=4096, opacity_reg=1e-5,
                   scale_reg=0.1, position_lr=0.3)
    oj = jfit.train_step(pj.tensors, pj.opt_state, jnp.asarray(ref_image),
                         optimizer=jfit.VisibilityAwareLaProp, config=cfg,
                         **step_kw)
  pt = TPC.create({k: torch.from_numpy(v.copy()) for k, v in a.items()},
                  tfit.make_parameter_groups(0.5),
                  optimizer_cls=tfit.VisibilityAwareLaProp, **kw)
  tcfg = pc.config(cfg)
  assert tfit.autosize_stream_caps(
      pc.config(JRasterConfig(compute_point_heuristic=True,
                              compute_visibility=True,
                              blur_cov=0.0 if antialias else 0.3,
                              antialias=antialias)), pt, SIZE) == tcfg
  ot = tfit.train_step(pt.tensors, pt.opt_state, torch.from_numpy(ref_image),
                       optimizer=tfit.VisibilityAwareLaProp, config=tcfg,
                       **step_kw)
  new_j, _, loss_j, image_j, vis_j, heur_j = oj
  new_t, _, loss_t, image_t, vis_t, heur_t = ot
  assert abs(float(loss_t) - float(loss_j)) <= 1e-5
  scale_close(image_t.numpy(), image_j, 1e-4, "image")
  for k in a:
    scale_close(new_t[k].numpy(), new_j[k], 1e-3, k)
  scale_close(vis_t.numpy(), vis_j, 1e-3, "visibility")
  scale_close(heur_t.numpy(), heur_j, 1e-3, "heuristics")
  for k in a:    # every tensor the optimizer owns moved
    if k != "depths":
      assert not np.array_equal(new_t[k].numpy(), a[k]), k


def test_fit_image_gaussians_smoke(capsys):
  """Fast tier, on the CPU: the trainer runs end to end and makes
  progress (the reference's floor)."""
  psnr = tfit.main(FAST + ["--device", "cpu"])
  assert psnr > 10, f"training made no progress: PSNR {psnr}"
  assert "final PSNR" in capsys.readouterr().out


def test_main_needs_a_card_or_the_cpu(monkeypatch):
  """No CPU fallback: without a card, only --device cpu runs."""
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(SystemExit, match="CUDA is not available"):
    tfit.main(FAST)


def test_same_seed_same_run():
  """Two runs from one seed draw the same splats and reach the same
  PSNR; the procedural target is the reference's."""
  args = FAST + ["--device", "cpu", "--iters", "5", "--prune"]
  assert tfit.main(args) == tfit.main(args)
  np.testing.assert_array_equal(
      tfit.load_image(tfit.parse_args(["--image_size", "48,32"]),
                      "cpu").numpy(),
      np.asarray(jfit.load_image(jfit.parse_args(["--image_size", "48,32"]))))


def test_make_epochs_and_split_prune_masks():
  """The epoch schedule and the split/prune selection are the
  reference's."""
  for args in ((2000, 8, 32), (40, 10, 20), (10, 5, 5), (500, 8, 32)):
    assert tfit.make_epochs(*args) == jfit.make_epochs(*args)
  rng = np.random.default_rng(3)
  cost, score = rng.random(100), rng.random(100)
  for target, n_prune in ((100, 5), (120, 10), (90, 0)):
    got = tfit.find_split_prune(100, target, n_prune, cost, score)
    want = jfit.find_split_prune(100, target, n_prune, cost, score)
    for g, w in zip(got, want):
      np.testing.assert_array_equal(g, w)


def test_split_prune_keeps_rows_in_step():
  """split_prune on the port: the target count, the kept rows' tensors
  and optimizer state carried over, the new rows' state zero."""
  a = splat_arrays(2)
  pt = TPC.create({k: torch.from_numpy(v.copy()) for k, v in a.items()},
                  tfit.make_parameter_groups(0.5),
                  optimizer_cls=tfit.VisibilityAwareLaProp, vis_smooth=0.1,
                  vis_beta=0.8)
  pt = pt.step({k: torch.ones_like(v) for k, v in pt.items()},
               torch.ones(N), basis=torch.eye(2).expand(N, 2, 2))
  heur = np.random.default_rng(4).random((N, 2)).astype(np.float32)
  out, metrics = tfit.split_prune(pt, torch.Generator().manual_seed(0), 0.5,
                                  N + 10, 0.05, heur)
  assert len(out) == N + 10 == N - metrics["prune"] + metrics["split"]
  kept = N - metrics["prune"] - metrics["split"]
  w = float(pt.opt_state.total_weight[0])
  assert w > 0 and torch.all(pt.opt_state.total_weight == w)
  assert torch.all(out.opt_state.total_weight[:kept] == w)
  assert torch.all(out.opt_state.total_weight[kept:] == 0)
  assert float(out.depths.min()) >= np.float32(1e-6)


@pytest.mark.slow
def test_fit_image_gaussians_converges():
  psnr = tfit.main(["--n", "200", "--iters", "40", "--epoch", "10",
                    "--max_epoch", "20", "--image_size", "64,48", "--prune",
                    "--max_overlaps", "16384", "--debug", "--device", "cpu"])
  assert psnr > 15, f"training failed to converge: PSNR {psnr}"


@pytest.mark.slow
def test_fit_image_gaussians_antialias():
  psnr = tfit.main(["--n", "100", "--iters", "20", "--epoch", "10",
                    "--image_size", "48,32", "--antialias",
                    "--max_overlaps", "8192", "--device", "cpu"])
  assert psnr > 12, f"antialias training failed: PSNR {psnr}"
