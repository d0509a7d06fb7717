"""Port vs reference: the examples ``render_ply``, ``vis_split`` and
``test_backward`` (``tpu_splatting_torch.examples``) on the CPU, and the
timing harness ``utils.benchmarked``.

``render_ply`` runs against the reference example on the same synthetic
PLY (the reference's ``ply`` with its native path off, as in
``test_torch_io.py``).  ``vis_split`` and ``test_backward`` render at
640x480 in the reference, which takes minutes in interpret mode, so both
run at 64x48 here (their ``IMAGE_SIZE``) against the reference's
``misc.renderer2d`` on the same fixture draws.
"""

import math
import os
import subprocess
import sys

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import port_compare as pc  # noqa: E402
import tpu_splatting as J  # noqa: E402
import tpu_splatting_torch as T  # noqa: E402
from random_data import random_2d_gaussians  # noqa: E402
from tpu_splatting.io import ply as jply  # noqa: E402
from tpu_splatting.misc import renderer2d as jr2d  # noqa: E402
from tpu_splatting_torch import scenes  # noqa: E402
from tpu_splatting_torch.examples import render_ply  # noqa: E402
from tpu_splatting_torch.examples import test_backward  # noqa: E402
from tpu_splatting_torch.examples import vis_split  # noqa: E402
from tpu_splatting_torch.io import ply as tply  # noqa: E402
from tpu_splatting_torch.utils import benchmarked as tb  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = (64, 48)
FIELDS = ("position", "depths", "log_scaling", "rotation", "alpha_logit",
          "feature")


@pytest.fixture
def ref_examples(monkeypatch):
  """The repository's ``examples`` package, its ``ply`` native path off."""
  monkeypatch.syspath_prepend(REPO)
  monkeypatch.setattr(jply, "_LIB", None)
  monkeypatch.setattr(jply, "_LIB_FAILED", True)
  from examples import render_ply as ref_render_ply
  return ref_render_ply


def test_render_ply_matches_reference(tmp_path, ref_examples):
  """``--synthetic 500 --image_size 64,48`` (the setting of
  ``tests/test_io_morton.py``) with ``--depth``: the same PLY bytes; the
  image and the depth image to 1e-5 (``test_torch_renderer.py``'s
  tolerance for ``render_gaussians``) at all but 0.1% of their values
  and every value within 1e-4; the weight mean to rtol 1e-5.  F8 shows
  here: one splat's f32 major axis (a near-diagonal covariance, ``a -
  lambda2`` cancels) differs by 5.8e-3 between the two packages'
  projections and moves 3 of the 9,216 values by up to 1.3e-5;
  ``test_render_ply_scene_in_f64`` renders the same file in f64, where
  every value agrees to 1e-10."""
  args = ["--synthetic", "500", "--image_size", "64,48", "--depth"]
  ref_out, port_out = tmp_path / "ref.npy", tmp_path / "port.npy"
  wm_ref = ref_examples.main([str(tmp_path / "ref.ply"), *args, "--out",
                              str(ref_out)])
  wm = render_ply.main([str(tmp_path / "port.ply"), *args, "--out",
                        str(port_out), "--device", "cpu"])
  assert ((tmp_path / "port.ply").read_bytes()
          == (tmp_path / "ref.ply").read_bytes())
  img, want = np.load(port_out), np.load(ref_out)
  assert img.shape == (48, 64, 3) and np.isfinite(img).all()
  depth = np.load(tmp_path / "port.depth.npy")
  want_depth = np.load(tmp_path / "ref.depth.npy")
  for got, ref in ((img, want), (depth, want_depth)):
    close = np.isclose(got, ref, atol=1e-5, rtol=1e-5)
    assert close.mean() >= 0.999, np.abs(got - ref).max()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
  assert wm > 0
  np.testing.assert_allclose(wm, wm_ref, rtol=1e-5)


def test_render_ply_scene_in_f64(tmp_path, ref_examples):
  """The example's scene and camera in f64 on both sides (each side's
  loader, ``look_at_pose`` and default ``RasterConfig``): image, weight
  and depth to 1e-10."""
  path = str(tmp_path / "s.ply")
  render_ply.synthetic_checkpoint(path, 500)
  gj = jax.tree.map(lambda x: x.astype(jnp.float64),
                    jply.load_gaussians(path))
  gt = tply.load_gaussians(path, device="cpu")
  gt = gt.replace(**{k: v.double() for k, v in vars(gt).items()})
  w, h = SMALL
  fx = (w / 2) / math.tan(math.radians(60.0) / 2)
  camera = J.CameraParams(
      projection=jnp.asarray([fx, fx, w / 2, h / 2], jnp.float64),
      T_camera_world=jnp.asarray(ref_examples.look_at_pose(
          [0.0, 0.0, -5.0], [0.0, 0.0, 0.0]), jnp.float64),
      near_plane=0.1, far_plane=100.0, image_size=SMALL)
  np.testing.assert_array_equal(
      render_ply.look_at_pose([0.0, 0.0, -5.0], [0.0, 0.0, 0.0]),
      np.asarray(camera.T_camera_world, np.float32))
  rj = jax.jit(lambda g: J.render_gaussians(
      g, camera, J.RasterConfig(), use_sh=True, render_depth=True))(gj)
  with torch.no_grad():
    rt = T.render_gaussians(gt, pc.camera(camera),
                            pc.config(J.RasterConfig()), use_sh=True,
                            render_depth=True)
  assert rt.image.dtype == torch.float64
  assert int(rt.num_overflow) == int(rj.num_overflow) == 0
  for name in ("image", "image_weight", "depth_image"):
    np.testing.assert_allclose(getattr(rt, name).numpy(),
                               np.asarray(getattr(rj, name)), atol=1e-10,
                               rtol=1e-10, err_msg=name)


def test_render_ply_needs_a_card_unless_told(tmp_path):
  if torch.cuda.is_available():
    pytest.skip("a CUDA device is present")
  with pytest.raises(SystemExit, match="CUDA is not available"):
    render_ply.main([str(tmp_path / "x.ply"), "--synthetic", "10"])
  for main in (vis_split.main, test_backward.main):
    with pytest.raises(SystemExit, match="CUDA is not available"):
      main([])


@pytest.mark.parametrize("kwargs", [
    dict(scale_factor=0.2, alpha_range=(1.0, 1.0)),     # vis_split's
    dict(scale_factor=10.0, alpha_range=(0.2, 0.3)),    # test_backward's
    dict(num_channels=5, depth_range=(0.2, 0.4)),
])
def test_random_2d_gaussians_match_fixture(kwargs):
  """The port's copy draws what ``tests/random_data.py`` draws."""
  want = random_2d_gaussians(np.random.default_rng(3), 7, (640, 480),
                             **kwargs)
  got = scenes.random_2d_gaussians(np.random.default_rng(3), 7, (640, 480),
                                   device="cpu", **kwargs)
  for name in FIELDS:
    a, b = getattr(got, name), np.asarray(getattr(want, name))
    assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, name
    np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


@pytest.mark.parametrize("uniform", [False, True])
def test_vis_split_matches_reference(tmp_path, monkeypatch, uniform):
  """The image before the split against the reference's render of the
  fixture's splats (atol 1e-5); the image after it is finite, written,
  and differs (the splits' draws come from a torch Generator, not from
  ``jax.random``)."""
  monkeypatch.setattr(vis_split, "IMAGE_SIZE", SMALL)
  argv = ["--device", "cpu", "--out", str(tmp_path)]
  before, after = vis_split.main(argv + (["--uniform"] if uniform else []))
  g = random_2d_gaussians(np.random.default_rng(0), 5, SMALL,
                          scale_factor=0.2, alpha_range=(1.0, 1.0))
  want = np.asarray(jax.jit(lambda g: jr2d.render_gaussians(g, SMALL).image)(
      g))
  assert float(want.max()) > 0.5
  np.testing.assert_allclose(before.numpy(), want, atol=1e-5, rtol=0)
  assert torch.isfinite(after).all() and float(after.max()) > 0.5
  assert not torch.equal(before, after)
  names = sorted(p.stem for p in tmp_path.iterdir())
  assert names == ["after_split", "before_split"]


def test_test_backward_matches_reference(monkeypatch):
  """The loss (rtol 1e-5) and each gradient (1e-3 of its largest
  magnitude, f32: F8) against ``jax.value_and_grad`` of the reference
  example's loss on the same splats."""
  monkeypatch.setattr(test_backward, "IMAGE_SIZE", SMALL)
  loss, grads = test_backward.main(["--device", "cpu"])
  g = random_2d_gaussians(np.random.default_rng(0), 1, SMALL,
                          scale_factor=10.0, alpha_range=(0.2, 0.3))
  config = J.RasterConfig(tile_size=16)

  def loss_j(g):
    return jnp.sum(jr2d.render_gaussians(g, SMALL, config).image)
  want, want_grads = jax.jit(jax.value_and_grad(loss_j))(g)
  np.testing.assert_allclose(loss, float(want), rtol=1e-5)
  assert loss > 0
  for name, got in grads.items():
    w = np.asarray(getattr(want_grads, name))
    scale = float(np.abs(w).max())
    assert scale > 0, name
    np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=1e-3 * scale,
                               err_msg=name)


@pytest.mark.parametrize("profile", [False, True])
def test_benchmarked_counts_calls(monkeypatch, tmp_path, capsys, profile):
  """``warmup`` calls, ``iters`` timed calls (and ``iters`` more under
  the profiler), a positive float, the reference's stderr line."""
  monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
  calls = []

  def f(x):
    calls.append(1)
    return x * 2
  ms = tb.benchmarked("double", f, (torch.ones(64),), iters=7, warmup=3,
                      profile=profile)
  assert isinstance(ms, float) and ms > 0
  assert len(calls) == 3 + 7 + (7 if profile else 0)
  err = capsys.readouterr().err
  assert err.splitlines()[-1].startswith("double: ")
  assert err.splitlines()[-1].endswith(" it/s)")
  if profile:
    assert (tmp_path / "tpu_splatting_torch_trace" / "double.json").exists()


def test_benchmarked_finds_cuda_tensors_in_dataclasses():
  """The harness looks for a CUDA tensor through dataclasses, dicts and
  sequences (here all on the CPU: host clock)."""
  g = scenes.random_2d_gaussians(np.random.default_rng(0), 3, SMALL,
                                 device="cpu")
  assert not tb._on_cuda((g, {"a": [torch.zeros(2)]}, 3, "s"))


def test_new_modules_need_no_jax_and_build_nothing():
  """Importing the IO, Morton, indexing, ref_lib, benchmarked and example
  modules leaves jax, tpu_splatting and bench out of sys.modules and
  builds nothing (the PLY library is built at the first read or
  write)."""
  code = (
      "import sys\n"
      "import tpu_splatting_torch.io, tpu_splatting_torch.io.ply, "
      "tpu_splatting_torch.misc.morton, tpu_splatting_torch.misc.indexing, "
      "tpu_splatting_torch.ref_lib, tpu_splatting_torch.utils.benchmarked, "
      "tpu_splatting_torch.examples.render_ply, "
      "tpu_splatting_torch.examples.vis_split, "
      "tpu_splatting_torch.examples.test_backward\n"
      "from tpu_splatting_torch.utils import cuda_build\n"
      "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
      "('jax', 'jaxlib', 'triton', 'tpu_splatting', 'bench'))\n"
      "assert not bad, bad\n"
      "assert not cuda_build._libs\n"
      "print('ok')\n")
  env = dict(os.environ)
  env.pop("PYTHONPATH", None)
  out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
  assert out.returncode == 0, out.stderr
  assert out.stdout.strip() == "ok"
