"""Port vs reference: PLY checkpoint IO (``io.ply``).

The reference's ``ply`` runs with its native path off (``_LIB_FAILED``,
as ``tests/test_io_morton.py`` does): its ``_build_lib`` compiles into
one shared path under the temporary directory without a lock, which
parallel test workers could load half-written.  Its numpy writer and
reader are what the port is held to here; ``test_io_morton.py`` covers
its native path.
"""

import struct

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import tpu_splatting as J  # noqa: E402
from tpu_splatting.io import ply as jply  # noqa: E402
from tpu_splatting_torch import Gaussians3D  # noqa: E402
from tpu_splatting_torch.io import ply  # noqa: E402
from tpu_splatting_torch.utils import cuda_build  # noqa: E402

FIELDS = ("position", "log_scaling", "rotation", "alpha_logit", "feature")


@pytest.fixture
def ref_ply(monkeypatch):
  """The reference's ply module with its native library off."""
  monkeypatch.setattr(jply, "_LIB", None)
  monkeypatch.setattr(jply, "_LIB_FAILED", True)
  return jply


def scene(n=100, sh_bands=4, seed=0):
  """{field: f32 array}: a scene with (N, 3, sh_bands^2) features."""
  rng = np.random.default_rng(seed)
  return dict(
      position=rng.standard_normal((n, 3)).astype(np.float32),
      log_scaling=rng.standard_normal((n, 3)).astype(np.float32),
      rotation=rng.standard_normal((n, 4)).astype(np.float32),
      alpha_logit=rng.standard_normal((n, 1)).astype(np.float32),
      feature=rng.standard_normal((n, 3, sh_bands ** 2)).astype(np.float32))


def port_gaussians(arrays):
  return Gaussians3D(**{k: torch.from_numpy(v.copy())
                        for k, v in arrays.items()})


def ref_gaussians(arrays):
  return J.Gaussians3D(**{k: jnp.asarray(v) for k, v in arrays.items()})


def assert_fields_equal(g, arrays):
  for name in FIELDS:
    got = getattr(g, name)
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(
        got)
    assert got.dtype == np.float32, name
    np.testing.assert_array_equal(got, arrays[name], err_msg=name)


@pytest.mark.parametrize("sh_bands", [1, 2, 4])
@pytest.mark.parametrize("reader", ["native", "numpy"])
def test_roundtrip(tmp_path, reader, sh_bands):
  """save_gaussians then a read, native or numpy: every field bit for
  bit, on the CPU."""
  arrays = scene(sh_bands=sh_bands, seed=sh_bands)
  path = str(tmp_path / "g.ply")
  ply.save_gaussians(path, port_gaussians(arrays))
  if reader == "native":
    g = ply.load_gaussians(path, device="cpu")
  else:
    g = ply._gaussians_from_props(ply._read_ply_raw_numpy(path), "cpu")
  assert g.position.device.type == "cpu"
  assert_fields_equal(g, arrays)


@pytest.mark.parametrize("sh_bands", [1, 2, 4])
def test_written_bytes_equal_reference(tmp_path, ref_ply, sh_bands):
  """The port's file is byte for byte the reference's for the same
  values, also through ``write_ply_raw`` and from (N, C) features."""
  arrays = scene(n=37, sh_bands=sh_bands, seed=10 + sh_bands)
  a, b = tmp_path / "port.ply", tmp_path / "ref.ply"
  ply.save_gaussians(str(a), port_gaussians(arrays))
  ref_ply.save_gaussians(str(b), ref_gaussians(arrays))
  assert a.read_bytes() == b.read_bytes()

  flat = dict(arrays, feature=arrays["feature"][:, :, 0])
  ply.save_gaussians(str(a), port_gaussians(flat))
  ref_ply.save_gaussians(str(b), ref_gaussians(flat))
  assert a.read_bytes() == b.read_bytes()

  props = {"x": arrays["position"][:, 0], "w": arrays["rotation"][:, 3]}
  ply.write_ply_raw(str(a), props)
  ref_ply.write_ply_raw(str(b), props)
  assert a.read_bytes() == b.read_bytes()


def test_each_side_reads_the_others_file(tmp_path, ref_ply):
  """A file written by the reference loads into the port's fields and
  one written by the port into the reference's, all equal to the
  values."""
  arrays = scene(n=64, sh_bands=3, seed=5)
  by_ref, by_port = str(tmp_path / "ref.ply"), str(tmp_path / "port.ply")
  ref_ply.save_gaussians(by_ref, ref_gaussians(arrays))
  ply.save_gaussians(by_port, port_gaussians(arrays))
  assert_fields_equal(ply.load_gaussians(by_ref, device="cpu"), arrays)
  assert_fields_equal(
      ply._gaussians_from_props(ply._read_ply_raw_numpy(by_ref), "cpu"),
      arrays)
  assert_fields_equal(ref_ply.load_gaussians(by_port), arrays)


def test_3dgs_layout_and_sh_ordering(tmp_path):
  """The hand-built canonical 3DGS checkpoint of
  ``tests/test_io_morton.py``: f_rest channel-major
  (f_rest_{i*(B-1)+j} = channel i, coefficient j+1), rot_* wxyz ->
  xyzw."""
  n, b = 4, 4                      # degree 3: B = 16 coefficients
  props = {}
  props["x"] = np.arange(n, dtype=np.float32)
  props["y"] = np.arange(n, dtype=np.float32) + 10
  props["z"] = np.arange(n, dtype=np.float32) + 20
  for k in ("nx", "ny", "nz"):
    props[k] = np.zeros(n, np.float32)
  for i in range(3):
    props[f"f_dc_{i}"] = np.full(n, 100.0 + i, np.float32)
  nb = b * b - 1                   # 15 rest coefficients per channel
  for i in range(3):
    for j in range(nb):
      props[f"f_rest_{i * nb + j}"] = np.full(n, 1000.0 * i + j, np.float32)
  props["opacity"] = np.linspace(-1, 1, n).astype(np.float32)
  for i in range(3):
    props[f"scale_{i}"] = np.full(n, 0.1 * i, np.float32)
  props["rot_0"] = np.ones(n, np.float32)          # wxyz identity
  for i in (1, 2, 3):
    props[f"rot_{i}"] = np.zeros(n, np.float32)

  path = str(tmp_path / "canonical.ply")
  ply.write_ply_raw(path, props)
  g = ply.load_gaussians(path, device="cpu")

  feat = g.feature.numpy()         # (N, 3, B^2)
  assert feat.shape == (n, 3, b * b)
  for i in range(3):
    np.testing.assert_array_equal(feat[:, i, 0], props[f"f_dc_{i}"])
    for j in range(nb):
      np.testing.assert_array_equal(
          feat[:, i, 1 + j], props[f"f_rest_{i * nb + j}"],
          err_msg=f"channel {i} coeff {j}")
  rot = g.rotation.numpy()
  np.testing.assert_array_equal(rot[:, 3], np.ones(n))
  np.testing.assert_array_equal(rot[:, :3], np.zeros((n, 3)))
  np.testing.assert_array_equal(g.position.numpy()[:, 1], props["y"])
  np.testing.assert_array_equal(g.alpha_logit.numpy()[:, 0],
                                props["opacity"])
  np.testing.assert_array_equal(g.log_scaling.numpy()[:, 2],
                                props["scale_2"])


def test_native_and_numpy_agree(tmp_path):
  g = port_gaussians(scene(n=57, sh_bands=2, seed=3))
  path = str(tmp_path / "x.ply")
  ply.save_gaussians(path, g)
  a = ply.read_ply_raw(path)
  b = ply._read_ply_raw_numpy(path)
  assert list(a) == list(b)
  for k in a:
    assert a[k].dtype == b[k].dtype == np.float32
    np.testing.assert_array_equal(a[k], b[k])


def write_header_file(path, header_lines, payload: bytes):
  with open(path, "wb") as f:
    f.write(("\n".join(["ply", "format binary_little_endian 1.0",
                        *header_lines, "end_header"]) + "\n").encode())
    f.write(payload)


def test_non_float_vertex_property(tmp_path, ref_ply):
  """F15: a ``uchar`` vertex property raises on both of the port's
  readers (as the native reader of ``csrc/ply_io.cpp`` does); the
  reference's numpy reader skips its name but still reads the payload as
  floats only, so its columns come out shifted."""
  xs, reds, ys = [0.0, 1.0, 2.0], [7, 8, 9], [10.0, 11.0, 12.0]
  payload = b"".join(struct.pack("<fBf", x, r, y)
                     for x, r, y in zip(xs, reds, ys))
  path = str(tmp_path / "uchar.ply")
  write_header_file(path, ["element vertex 3", "property float x",
                           "property uchar red", "property float y"],
                    payload)
  with pytest.raises(IOError, match="non-float vertex property"):
    ply.read_ply_raw(path)
  with pytest.raises(IOError, match="non-float vertex property"):
    ply._read_ply_raw_numpy(path)
  with pytest.raises(IOError, match="non-float vertex property"):
    ply.load_gaussians(path, device="cpu")
  got = ref_ply._read_ply_raw_numpy(path)
  assert sorted(got) == ["x", "y"]
  assert not np.array_equal(got["x"], np.float32(xs)), got["x"]
  assert not np.array_equal(got["y"], np.float32(ys)), got["y"]


def test_later_element_properties(tmp_path, ref_ply):
  """The properties of an element after the vertex element are not
  vertex properties: both of the port's readers leave them out and read
  the vertex rows; the reference's numpy reader counts them as vertex
  properties and misreads the rows (F15)."""
  values = np.arange(9, dtype="<f4")     # 3 vertices (x, y), 3 rows (q)
  path = str(tmp_path / "extra.ply")
  write_header_file(path, ["element vertex 3", "property float x",
                           "property float y", "element extra 3",
                           "property float q"], values.tobytes())
  for got in (ply.read_ply_raw(path), ply._read_ply_raw_numpy(path)):
    assert list(got) == ["x", "y"]
    np.testing.assert_array_equal(got["x"], values[0:6:2])
    np.testing.assert_array_equal(got["y"], values[1:6:2])
  got = ref_ply._read_ply_raw_numpy(path)
  assert list(got) == ["x", "y", "q"]
  np.testing.assert_array_equal(got["x"], values[0::3])


@pytest.mark.parametrize("header, message", [
    (["element vertex 3", "property float x"], "short read"),
    (["element face 3"], "no vertex element"),
])
def test_malformed_files_raise(tmp_path, header, message):
  """Both readers refuse a short payload and a file with no vertex
  properties, with the native reader's words."""
  path = str(tmp_path / "bad.ply")
  write_header_file(path, header, np.zeros(2, "<f4").tobytes())
  for read in (ply.read_ply_raw, ply._read_ply_raw_numpy):
    with pytest.raises(IOError, match=message):
      read(path)


def test_load_gaussians_defaults_to_the_card(tmp_path):
  """Without ``device`` the scene goes to the card, and where there is
  none load_gaussians raises."""
  if torch.cuda.is_available():
    pytest.skip("a CUDA device is present")
  path = str(tmp_path / "g.ply")
  ply.save_gaussians(path, port_gaussians(scene(n=8)))
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    ply.load_gaussians(path)


def test_build_failure_raises(tmp_path, monkeypatch):
  """Where g++ cannot build the library, reading and writing raise:
  there is no numpy fallback."""
  monkeypatch.delitem(cuda_build._libs, "ply_io.cpp", raising=False)
  monkeypatch.setattr(cuda_build, "GXX_FLAGS",
                      cuda_build.GXX_FLAGS + ("-include", "missing.h"))
  monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
  path = str(tmp_path / "g.ply")
  with pytest.raises(RuntimeError, match="g\\+\\+ failed to build"):
    ply.write_ply_raw(path, {"x": np.zeros(3, np.float32)})
  with pytest.raises(RuntimeError, match="g\\+\\+ failed to build"):
    ply.read_ply_raw(path)


def test_save_from_any_tensor_dtype_and_grad(tmp_path, ref_ply):
  """save_gaussians takes tensors that need grad and f64 tensors (cast to
  f32 as the reference's np.asarray(..., np.float32) does)."""
  arrays = scene(n=20, sh_bands=2, seed=8)
  g = Gaussians3D(**{k: torch.from_numpy(v.astype(np.float64))
                     .requires_grad_() for k, v in arrays.items()})
  a, b = tmp_path / "port.ply", tmp_path / "ref.ply"
  ply.save_gaussians(str(a), g)
  ref_ply.save_gaussians(str(b), ref_gaussians(
      {k: v.astype(np.float64) for k, v in arrays.items()}))
  assert a.read_bytes() == b.read_bytes()
  assert_fields_equal(ply.load_gaussians(str(a), device="cpu"), arrays)
