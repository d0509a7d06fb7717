"""Port vs reference: the 2D gaussian path, ``misc/renderer2d.py``.

The same numpy splats (64 at 48x32, f32, from a seed) go through
``tpu_splatting.misc.renderer2d`` and ``tpu_splatting_torch.misc.renderer2d``.
The bases and packings agree to 1e-6; ``render_with_heuristics`` on the
stream and the sorted pipelines gives the image within 1e-5, the loss
within 1e-5, and each gradient leaf, the heuristics and the visibility
within 1e-3 of that leaf's largest magnitude (f32 projection
conditioning, ROADMAP F8).  The split functions agree to 1e-6 where they
draw nothing (``depth_noise=0``, ``random_axis=False``, given offsets);
with noise the two frameworks draw different numbers, so only shapes and
the depth floor are held.
"""

import dataclasses
import subprocess
import sys

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from tests import port_compare as pc  # noqa: E402
from tpu_splatting import RasterConfig as JRasterConfig  # noqa: E402
from tpu_splatting import data_types as jdt  # noqa: E402
from tpu_splatting.misc import renderer2d as jr  # noqa: E402
from tpu_splatting_torch import data_types as tdt  # noqa: E402
from tpu_splatting_torch.misc import renderer2d as tr  # noqa: E402

N, SIZE = 64, (48, 32)
FIELDS = ("position", "depths", "log_scaling", "rotation", "alpha_logit",
          "feature")


def splat_arrays(seed=0, n=N):
  rng = np.random.default_rng(seed)
  w, h = SIZE
  return {k: v.astype(np.float32) for k, v in {
      "position": rng.uniform(0, 1, (n, 2)) * [w, h],
      "depths": rng.uniform(0.05, 0.95, n),
      "log_scaling": np.log(rng.uniform(0.8, 4.0, (n, 2))),
      "rotation": rng.standard_normal((n, 2)),
      "alpha_logit": rng.normal(1.0, 1.0, (n, 1)),
      "feature": rng.uniform(0, 1, (n, 3))}.items()}


def both(arrays):
  return (jdt.Gaussians2D(**{k: jnp.asarray(v) for k, v in arrays.items()}),
          tdt.Gaussians2D(**{k: torch.from_numpy(v.copy())
                             for k, v in arrays.items()}))


def close(got, want, atol):
  got, want = np.asarray(got), np.asarray(want)
  assert got.shape == want.shape, (got.shape, want.shape)
  np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def scale_close(got, want, rel=1e-3, label=""):
  want = np.asarray(want)
  close(got, want, rel * max(float(np.abs(want).max()), 1e-12))


@pytest.mark.parametrize("fn", ["project_gaussians2d", "point_basis",
                                "point_rotation", "point_covariance"])
def test_packings_and_bases(fn):
  gj, gt = both(splat_arrays())
  want = np.asarray(getattr(jr, fn)(gj))
  close(getattr(tr, fn)(gt).numpy(), want,
        1e-6 * max(float(np.abs(want).max()), 1.0))


def test_repeat_sample_and_split_with_offsets():
  """Given samples and offsets, nothing is drawn: within 1e-6."""
  a = splat_arrays(1)
  gj, gt = both(a)
  samples = np.random.default_rng(2).standard_normal((N, 3, 2)).astype(
      np.float32)
  want = np.asarray(jr.repeat_sample_gaussians(jnp.asarray(samples), gj, 3))
  got = tr.repeat_sample_gaussians(torch.from_numpy(samples), gt, 3).numpy()
  close(got, want, 1e-6 * max(float(np.abs(want).max()), 1.0))
  sj = jr.split_with_offsets(gj, jnp.asarray(want), jax.random.PRNGKey(0),
                             depth_noise=0.0)
  st = tr.split_with_offsets(gt, torch.from_numpy(got.copy()),
                             torch.Generator().manual_seed(0),
                             depth_noise=0.0)
  for k in FIELDS:
    ref = np.asarray(getattr(sj, k))
    close(getattr(st, k).numpy(), ref,
          1e-6 * max(float(np.abs(ref).max()), 1.0))


@pytest.mark.parametrize("n", [2, 3])
def test_uniform_split_without_noise(n):
  gj, gt = both(splat_arrays(3))
  sj = jr.uniform_split_gaussians2d(gj, jax.random.PRNGKey(1), n=n,
                                    depth_noise=0.0)
  st = tr.uniform_split_gaussians2d(gt, torch.Generator().manual_seed(1),
                                    n=n, depth_noise=0.0)
  assert len(st) == n * N
  for k in FIELDS:
    ref = np.asarray(getattr(sj, k))
    close(getattr(st, k).numpy(), ref,
          1e-6 * max(float(np.abs(ref).max()), 1.0))


@pytest.mark.parametrize("split", ["split_gaussians2d",
                                   "uniform_split_gaussians2d"])
def test_splits_with_noise(split):
  """Random draws: the reference's shapes, depths at least 1e-6, the
  same draws from the same generator seed, and a random axis that is one
  of the two."""
  a = splat_arrays(4)
  a["depths"][:8] = 0.0          # noise may push these below zero
  gj, gt = both(a)
  kw = {"random_axis": True} if split.startswith("uniform") else {}
  sj = getattr(jr, split)(gj, jax.random.PRNGKey(2), depth_noise=0.1, **kw)
  st = getattr(tr, split)(gt, torch.Generator().manual_seed(2),
                          depth_noise=0.1, **kw)
  again = getattr(tr, split)(gt, torch.Generator().manual_seed(2),
                             depth_noise=0.1, **kw)
  for k in FIELDS:
    assert getattr(st, k).shape == getattr(sj, k).shape, k
    assert torch.equal(getattr(st, k), getattr(again, k)), k
  assert float(st.depths.min()) >= np.float32(1e-6)   # the f32 floor
  assert float(np.asarray(sj.depths).min()) >= np.float32(1e-6)
  assert not torch.equal(st.depths, gt.depths.repeat_interleave(2))
  if kw:   # one axis of each split point shrank by 1/sqrt(2)
    ratio = (st.scaling[::2] / gt.scaling).numpy()
    shrunk = np.isclose(ratio, 1 / np.sqrt(2), rtol=1e-5)
    assert np.all(shrunk.sum(1) == 1)
    assert np.all(np.isclose(ratio, 1.0, rtol=1e-5).sum(1) == 1)


def loss_fns(ref_image):
  """The trainer's loss on either side: MSE against a target plus the
  opacity and scale regularisers, so every leaf has a gradient."""
  w, h = SIZE

  def jloss(out, g):
    scale = jnp.exp(g.log_scaling) / min(w, h)
    return (jnp.mean((out.image - jnp.asarray(ref_image)) ** 2)
            + 1e-2 * jnp.mean(g.opacity) + 0.1 * jnp.mean(scale ** 2))

  ref_t = torch.from_numpy(ref_image)

  def tloss(out, g):
    scale = torch.exp(g.log_scaling) / min(w, h)
    return (torch.mean((out.image - ref_t) ** 2)
            + 1e-2 * torch.mean(g.opacity) + 0.1 * torch.mean(scale ** 2))
  return jloss, tloss


@pytest.mark.parametrize("pipeline", ["stream", "sorted"])
def test_render_with_heuristics(pipeline):
  """Image within 1e-5, loss within 1e-5, every gradient leaf, the
  heuristics and the visibility within 1e-3 of their scale; no overflow
  on either side."""
  gj, gt = both(splat_arrays(5))
  cfg = JRasterConfig(compute_point_heuristic=True, compute_visibility=True,
                      pipeline=pipeline)
  ref_image = np.random.default_rng(6).uniform(
      0, 1, (SIZE[1], SIZE[0], 3)).astype(np.float32)
  jloss, tloss = loss_fns(ref_image)
  with jax.enable_x64(False):
    lj, oj, dj = jr.render_with_heuristics(jloss, gj, SIZE, cfg,
                                           max_overlaps=4096)
  lt, ot, dt = tr.render_with_heuristics(tloss, gt, SIZE, pc.config(cfg),
                                         max_overlaps=4096)
  assert int(oj.num_overflow.sum()) == 0 and int(ot.num_overflow.sum()) == 0
  assert float(np.abs(np.asarray(oj.image)).max()) > 0.1
  close(ot.image.numpy(), oj.image, 1e-5)
  close(ot.image_weight.numpy(), oj.image_weight, 1e-5)
  assert abs(float(lt) - float(lj)) <= 1e-5
  for f in dataclasses.fields(dt):
    scale_close(getattr(dt, f.name).numpy(), getattr(dj, f.name),
                label=f.name)
  scale_close(ot.point_heuristic.numpy(), oj.point_heuristic)
  scale_close(ot.visibility.numpy(), oj.visibility)
  assert ot.image.grad_fn is None and float(ot.visibility.max()) > 0


def test_render_gaussians_forward():
  """The forward alone, stream pipeline: the image within 1e-5."""
  gj, gt = both(splat_arrays(7))
  cfg = JRasterConfig()
  with jax.enable_x64(False):
    oj = jr.render_gaussians(gj, SIZE, cfg)
  ot = tr.render_gaussians(gt, SIZE, pc.config(cfg))
  close(ot.image.numpy(), oj.image, 1e-5)


def test_port_modules_import_no_jax():
  """The port's 2D path, ParameterClass, check_finite and the trainer,
  imported alone, bring in no JAX, nothing of the JAX package and nothing
  of its benchmarks."""
  code = ("import sys, tpu_splatting_torch.misc.renderer2d, "
          "tpu_splatting_torch.utils.check_finite, "
          "tpu_splatting_torch.examples.fit_image_gaussians; "
          "from tpu_splatting_torch.optim import ParameterClass; "
          "print(sorted(m for m in sys.modules if m.split('.')[0] in "
          "('jax', 'jaxlib', 'tpu_splatting', 'benchmarks')))")
  out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, check=True)
  assert out.stdout.strip() == "[]"
