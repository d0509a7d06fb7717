"""Port vs reference: the multi-device paths (``parallel/``) on virtual
CPU shards.

* ``band_sharded_forward`` bit for bit the port's unsharded twin, and
  against JAX's ``band_sharded_forward`` at the stream forward tests'
  atol / rtol 1e-5.
* ``band_sharded_grad``'s per-point gradients against the port's
  unsharded ``stream_reduce`` (atol 1e-6, rtol 1e-5: the halo merge adds
  a row's edge contributions in another order) and against JAX's
  ``band_sharded_grad`` (atol 1e-5, rtol 1e-4, the K2 twin's tolerance
  against the reference's merged slabs).
* K3's halo mode: each shard's merged own bands (the K2 twin in halo mode,
  then the halo merge twin) against the reference's
  ``merge_grad_slabs(..., halo=True)`` on the same shard, computed by hand
  as ``band_sharded_grad``'s shard body does (atol 1e-5, rtol 1e-4).
* ``data_parallel_loss``: loss (rtol 1e-5) and probe-gradient visibility
  (rtol 1e-4, atol 1e-5) against JAX's per-camera loop; one
  ``make_train_step`` step against the port's one-device step.
* ``sharded_projection``, ``dryrun_multichip`` and ``make_mesh``.

``test_torch_parallel_train.py`` holds ``make_train_step`` and
``sharded_projection`` against the JAX package's own multi-device
functions.
"""

import dataclasses

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

import port_compare as pc  # noqa: E402
from test_parallel import make_scene as make_3d_scene  # noqa: E402
from test_stream import make_scene  # noqa: E402
from tpu_splatting import RasterConfig  # noqa: E402
from tpu_splatting import render_gaussians as j_render  # noqa: E402
from tpu_splatting.parallel import stream_sharded as jss  # noqa: E402
from tpu_splatting.rasterizer import stream as jstream  # noqa: E402
from tpu_splatting.rasterizer import stream_kernels as jkern  # noqa: E402
from tpu_splatting_torch import Gaussians3D  # noqa: E402
from tpu_splatting_torch.optim import (GroupConfig,  # noqa: E402
                                       VisibilityAwareLaProp)
from tpu_splatting_torch.parallel import data_parallel as tdp  # noqa: E402
from tpu_splatting_torch.parallel import mesh as tmesh  # noqa: E402
from tpu_splatting_torch.parallel import stream_sharded as tss  # noqa: E402
from tpu_splatting_torch.parallel.dryrun import (  # noqa: E402
    dryrun_multichip)
from tpu_splatting_torch.perspective import project_to_image  # noqa: E402
from tpu_splatting_torch.rasterizer import (  # noqa: E402
    stream_function as tfun)
from tpu_splatting_torch.rasterizer import (  # noqa: E402
    stream_kernels as tkern)
from tpu_splatting_torch.renderer import render_gaussians  # noqa: E402

CONFIG = RasterConfig(tile_size=8, chunk_size=8)
SIZE = (32, 32)                 # 4 x 4 tiles: th = 4 bands
N_SHARDS = 4


@pytest.fixture(scope="module")
def band_scene():
  """The reference's band-sharding scene (tests/test_parallel.py): the
  JAX mapping, the port's copy of it and an image cotangent."""
  packed, depths, feats = make_scene(23, 90, SIZE)
  mj = jstream.stream_map(packed, depths, feats, SIZE, CONFIG, group_width=2,
                          num_slabs=2, strip_cap=128, slab_cap=256, w_max=16,
                          run_cap=16)
  assert int(mj.num_overflow) == 0
  img = jkern.stream_forward(mj, CONFIG)
  gimg = np.random.default_rng(0).standard_normal(img.shape).astype(
      np.float32)
  return mj, pc.mapping(mj), np.array(img), gimg


def cpu_mesh(n):
  return tmesh.make_mesh(n, devices=["cpu"] * n)


def jax_mesh(n):
  return JMesh(jax.devices("cpu")[:n], ("y",))


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_band_sharded_forward_is_the_unsharded_image(band_scene, n_shards):
  _, mt, _, _ = band_scene
  cfg = pc.config(CONFIG)
  want = tkern.stream_forward(mt, cfg)
  got = tss.band_sharded_forward(mt, cfg, cpu_mesh(n_shards))
  assert float(want.abs().max()) > 0.1
  torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_band_sharded_forward_matches_reference(band_scene):
  mj, mt, _, _ = band_scene
  want = jax.jit(lambda: jss.band_sharded_forward(
      mj, CONFIG, jax_mesh(N_SHARDS)))()
  got = tss.band_sharded_forward(mt, pc.config(CONFIG), cpu_mesh(N_SHARDS))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                             rtol=1e-5)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_band_sharded_grad_matches_unsharded(band_scene, n_shards):
  _, mt, img, gimg = band_scene
  cfg = pc.config(CONFIG)
  buf = tkern.stream_backward(mt, torch.from_numpy(img),
                              torch.from_numpy(gimg), cfg)
  want = tfun.stream_reduce(buf, mt)
  img_sh, got = tss.band_sharded_grad(mt, torch.from_numpy(gimg), cfg,
                                      cpu_mesh(n_shards))
  assert got.shape == (mt.num_points, tkern.slab_width(cfg, 3))
  assert float(want.abs().max()) > 0.1
  torch.testing.assert_close(img_sh, tkern.stream_forward(mt, cfg), atol=0,
                             rtol=0)
  torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)


def test_band_sharded_grad_matches_reference(band_scene):
  mj, mt, _, gimg = band_scene
  _, cols = jax.jit(lambda g: jss.band_sharded_grad(
      mj, g, CONFIG, jax_mesh(N_SHARDS)))(jnp.asarray(gimg))
  want = np.stack([np.asarray(c) for c in cols], -1)
  _, got = tss.band_sharded_grad(mt, torch.from_numpy(gimg),
                                 pc.config(CONFIG), cpu_mesh(N_SHARDS))
  np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)


def reference_merged_bands(mj, gimg, n_shards):
  """Per shard, the reference's merged own-band columns (th_local * tw *
  run_cap, slabw): ``band_sharded_grad``'s shard body by hand, the
  neighbours' edge slab blocks as its two ppermutes deliver them (zeros
  where a shard has no peer)."""
  th_local = mj.tiles_high // n_shards
  groups_x = mj.tiles_wide // mj.group_width
  gpb = groups_x * th_local
  t_local = mj.tiles_wide * th_local
  slabw = jkern.slab_width(CONFIG, mj.feature_size)
  rc = mj.run_cap

  @jax.jit
  def shard_gout(desc, strip_blk, g, band0):
    lm = jss._local_mapping(mj, desc, strip_blk, mj.table, mj.run_starts,
                            (mj.num_overflow, mj.overflow), th_local)
    img = jkern.stream_forward(lm, CONFIG, band0=band0)
    return jkern.stream_backward(lm, img, g, CONFIG, rc, band0=band0)

  gouts, lms = [], []
  for d in range(n_shards):
    desc = mj.desc[d * gpb:(d + 1) * gpb]
    sb = mj.strip_blk[d * gpb:(d + 1) * gpb]
    gouts.append(shard_gout(desc, sb, jnp.asarray(
        gimg[d * t_local:(d + 1) * t_local]), jnp.int32(d * th_local)))
    lms.append(jss._local_mapping(mj, desc, sb, mj.table, mj.run_starts,
                                  (mj.num_overflow, mj.overflow), th_local))
  zero = jnp.zeros_like(gouts[0][:groups_x])
  merged = []
  for d in range(n_shards):
    above = gouts[d - 1][-groups_x:] if d > 0 else zero
    below = gouts[d + 1][:groups_x] if d < n_shards - 1 else zero
    cols = jkern.merge_grad_slabs(
        jnp.concatenate([above, gouts[d], below], 0), lms[d], rc, slabw,
        halo=True)
    merged.append(np.stack([np.asarray(c) for c in cols], -1))
  return merged


@pytest.mark.parametrize("n_shards", [2, 4])
def test_halo_merge_matches_reference_halo_mode(band_scene, n_shards):
  """K3's halo mode at its boundary: shard d's merged own bands, every
  shard (the first and the last have one missing peer each)."""
  mj, mt, _, gimg = band_scene
  cfg = pc.config(CONFIG)
  th_local = mt.tiles_high // n_shards
  t_local = mt.tiles_wide * th_local
  band_rows = mt.tiles_wide * mt.run_cap
  bufs = []
  for d in range(n_shards):
    lm = tss._local_mapping(mt, d, th_local, "cpu")
    band0 = d * th_local
    img = tkern.stream_forward(lm, cfg, band0)
    buf = tkern.stream_backward(
        lm, img, torch.from_numpy(gimg[d * t_local:(d + 1) * t_local]), cfg,
        band0, halo=True)
    assert buf.shape == ((th_local + 2) * band_rows + 1,
                         tkern.slab_width(cfg, 3))
    assert not buf[-1].any()
    bufs.append(buf)
  # no row of a real home lands in a halo band whose peer is missing
  assert not bufs[0][:band_rows].any()
  assert not bufs[-1][(th_local + 1) * band_rows:-1].any()
  want = reference_merged_bands(mj, gimg, n_shards)
  for d in range(n_shards):
    above = (bufs[d - 1][(th_local + 1) * band_rows:-1].clone()
             if d > 0 else None)
    below = bufs[d + 1][:band_rows].clone() if d < n_shards - 1 else None
    got = tkern.halo_merge(bufs[d].clone(), th_local, band_rows, above,
                           below)
    assert got.shape == want[d].shape
    assert float(np.abs(want[d]).max()) > 0.1
    np.testing.assert_allclose(got.numpy(), want[d], atol=1e-5, rtol=1e-4,
                               err_msg=f"shard {d}")


@pytest.mark.parametrize("th_local", [1, 3])
def test_halo_merge_adds_in_the_twin_order(th_local):
  """In place, into the first and last own bands only; above before below
  where they are one band; a missing peer adds nothing."""
  band_rows, slabw = 6, 5
  rng = np.random.default_rng(4)
  buf0 = torch.from_numpy(rng.standard_normal(
      ((th_local + 2) * band_rows + 1, slabw)).astype(np.float32))
  above = torch.from_numpy(rng.standard_normal((band_rows, slabw)).astype(
      np.float32))
  below = torch.from_numpy(rng.standard_normal((band_rows, slabw)).astype(
      np.float32))
  for a, b in ((above, below), (None, below), (above, None), (None, None)):
    buf = buf0.clone()
    own = tkern.halo_merge(buf, th_local, band_rows, a, b)
    want = buf0[band_rows:(th_local + 1) * band_rows].clone()
    if a is not None:
      want[:band_rows] = want[:band_rows] + a
    if b is not None:
      want[-band_rows:] = want[-band_rows:] + b
    torch.testing.assert_close(own, want, atol=0, rtol=0)
    assert own.data_ptr() == buf[band_rows:].data_ptr()
    torch.testing.assert_close(buf[:band_rows], buf0[:band_rows])
    torch.testing.assert_close(buf[(th_local + 1) * band_rows:],
                               buf0[(th_local + 1) * band_rows:])


def test_band0_without_halo_raises(band_scene):
  """A shard's K2 needs its halo bands: without them the rows its edge
  tiles home in the neighbouring shards would be dropped."""
  _, mt, img, gimg = band_scene
  lm = tss._local_mapping(mt, 1, 1, "cpu")
  t_local = mt.tiles_wide
  with pytest.raises(ValueError, match="band0"):
    tkern.stream_backward(lm, torch.from_numpy(img[t_local:2 * t_local]),
                          torch.from_numpy(gimg[t_local:2 * t_local]),
                          pc.config(CONFIG), 1)


def camera_batch(camera, b, seed):
  """b poses (small translations of the camera's) and targets."""
  poses = np.tile(np.asarray(camera.T_camera_world), (b, 1, 1))
  poses[:, 0, 3] += 1e-3 * np.arange(b)
  projections = np.tile(np.asarray(camera.projection), (b, 1))
  w, h = camera.image_size
  targets = np.random.default_rng(seed).random((b, h, w, 3)).astype(
      np.float32)
  return projections, poses.astype(np.float32), targets


def test_data_parallel_loss_matches_reference_loop():
  """2 shards, 4 cameras: the mean loss and the probe-gradient visibility
  summed over the batch, against JAX's one-device loop over the cameras
  (tests/test_parallel.py's reference)."""
  from tpu_splatting.rasterizer.stream_function import probe_width
  gaussians, camera = make_3d_scene()
  config = RasterConfig(tile_size=16, chunk_size=16, compute_visibility=True)
  b = 4
  projections, poses, targets = camera_batch(camera, b, 1)
  n = gaussians.position.shape[0]
  pw = probe_width(config)

  @jax.jit
  @jax.value_and_grad
  def cam_loss(probe, proj, pose, target):
    cam = camera.replace(projection=proj, T_camera_world=pose)
    out = j_render(gaussians, cam, config, max_overlaps=4096, probe=probe)
    return jnp.mean((out.image - target) ** 2)

  probe = jnp.zeros((n, pw), jnp.float32)
  losses, vis_want = [], 0.0
  for i in range(b):
    li, gi = cam_loss(probe, projections[i], poses[i], targets[i])
    losses.append(float(li))
    vis_want = vis_want + np.asarray(gi[:, 0])
  loss_want = np.mean(losses)

  loss_fn = tdp.data_parallel_loss(cpu_mesh(2), pc.camera(camera),
                                   pc.config(config), max_overlaps=4096)
  tprobe = torch.zeros((n, pw), requires_grad=True)
  loss, fwd_vis = loss_fn(pc.gaussians(gaussians), tprobe,
                          torch.from_numpy(projections),
                          torch.from_numpy(poses), torch.from_numpy(targets))
  (gpr,) = torch.autograd.grad(loss, tprobe)
  vis = (fwd_vis + gpr[:, 0]).numpy()
  assert vis.max() > 0.1
  np.testing.assert_allclose(float(loss.detach()), loss_want, rtol=1e-5)
  np.testing.assert_allclose(vis, vis_want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("pipeline", ["stream", "sorted"])
def test_train_step_matches_one_device_step(pipeline):
  """One make_train_step step on 2 shards equals the one-device
  visibility-aware step over the same cameras (gradients summed over the
  batch, visibility from the probe or the forward)."""
  gaussians, camera = make_3d_scene()
  config = pc.config(RasterConfig(tile_size=16, chunk_size=16,
                                  pipeline=pipeline))
  tcam = pc.camera(camera)
  b = 4
  projections, poses, targets = (torch.from_numpy(x) for x in camera_batch(
      camera, b, 2))
  groups = {k: GroupConfig(type="scalar", lr=0.05)
            for k in ["position", "log_scaling", "rotation", "alpha_logit"]}
  groups["feature"] = GroupConfig(type="vector", lr=0.05)
  g = pc.gaussians(gaussians)
  tensors = {f.name: getattr(g, f.name) for f in dataclasses.fields(g)}
  step, opt = tdp.make_train_step(cpu_mesh(2), tcam, config, groups,
                                  max_overlaps=4096)
  got, _, loss = step(tensors, opt.init(tensors), projections, poses,
                      targets)

  vis_cfg = dataclasses.replace(config, compute_visibility=True)
  leaves = {k: v.detach().requires_grad_(True) for k, v in tensors.items()}
  probe = torch.zeros((tensors["position"].shape[0], 1), requires_grad=True)
  losses, vis_fwd = [], 0.0
  for i in range(b):
    cam = tcam.replace(projection=projections[i], T_camera_world=poses[i])
    out = render_gaussians(Gaussians3D(**leaves), cam, vis_cfg,
                           max_overlaps=4096, probe=probe)
    losses.append(torch.mean((out.image - targets[i]) ** 2))
    if out.points._visibility is not None:
      vis_fwd = vis_fwd + out.points._visibility
  ref_loss = torch.stack(losses).mean()
  grads = torch.autograd.grad(ref_loss, list(leaves.values()) + [probe],
                              allow_unused=True)
  grads = [torch.zeros_like(x) if gr is None else gr
           for x, gr in zip(list(leaves.values()) + [probe], grads)]
  vis = vis_fwd + grads[-1][:, 0]
  assert float(vis.max()) > 0.1
  ref_opt = VisibilityAwareLaProp(groups)
  want, _ = ref_opt.step(tensors, dict(zip(leaves, grads[:-1])),
                         ref_opt.init(tensors), vis)
  torch.testing.assert_close(loss, ref_loss.detach(), atol=0, rtol=1e-6)
  for k in tensors:
    torch.testing.assert_close(got[k], want[k], atol=1e-6, rtol=1e-5,
                               msg=k)


def test_sharded_projection_matches_project_to_image():
  gaussians, camera = make_3d_scene(n_points=256)
  g, cam, cfg = pc.gaussians(gaussians), pc.camera(camera), pc.config(
      RasterConfig())
  points, depth, in_view = tdp.sharded_projection(
      cpu_mesh(4), cam, cfg)(g)
  want = project_to_image(g, cam, cfg)
  assert points.shape == (256, 7)
  torch.testing.assert_close(points, want[0], atol=1e-5, rtol=1e-5)
  torch.testing.assert_close(depth, want[1], atol=1e-5, rtol=1e-5)
  assert torch.equal(in_view, want[2])


def test_dryrun_multichip_on_virtual_cpu_shards(capsys):
  dryrun_multichip(4, devices=["cpu"] * 4)
  assert "OK" in capsys.readouterr().out


def test_make_mesh():
  """Repeated devices make virtual shards; asking for more devices than
  are listed, or than the visible CUDA devices, raises."""
  mesh = tmesh.make_mesh(4, devices=["cpu"] * 4)
  assert mesh.devices == (torch.device("cpu"),) * 4
  assert mesh.size == 4
  assert tmesh.make_mesh(2, devices=["cpu"] * 3).size == 2
  with pytest.raises(AssertionError, match="need 5 devices"):
    tmesh.make_mesh(5, devices=["cpu"] * 4)
  with pytest.raises(AssertionError):
    tmesh.make_mesh(torch.cuda.device_count() + 1)


def test_collectives():
  """ppermute delivers None where no shard sends; all_gather and psum land
  on the first device, and their gradients reach every shard."""
  mesh = cpu_mesh(3)
  xs = [torch.full((2,), float(i), requires_grad=True) for i in range(3)]
  out = tmesh.ppermute(mesh, xs, [(0, 1), (1, 2)])
  assert out[0] is None and torch.equal(out[2], xs[1])
  gathered = tmesh.all_gather(mesh, xs)
  assert gathered.tolist() == [0.0, 0.0, 1.0, 1.0, 2.0, 2.0]
  total = tmesh.psum(mesh, xs)
  assert total.tolist() == [3.0, 3.0]
  grads = torch.autograd.grad((gathered * 2).sum() + total.sum(), xs)
  assert all(gr.tolist() == [3.0, 3.0] for gr in grads)
