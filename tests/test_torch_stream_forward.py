"""Port vs reference: the stream forward (K1).

The port's plain twin ``stream_forward_reference`` against the JAX
``stream_forward`` in interpret mode, (a) on the mapping the JAX mapper
built, converted with ``convert.py``, and (b) on the port's own mapping;
blending and quantile modes, antialias on and off.  Tolerance atol/rtol
1e-5 (as tests/test_stream.py holds the stream pipeline to the sorted
one).  The scenes keep a_raw away from alpha_threshold (ROADMAP F1).
The kernel itself is held against the twin in test_torch_gpu.py.
"""

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import port_compare as pc  # noqa: E402
from test_stream import TIGHT, make_scene  # noqa: E402
from test_torch_stream_map import wide_scene  # noqa: E402
from tpu_splatting import RasterConfig  # noqa: E402
from tpu_splatting.rasterizer import stream as jstream  # noqa: E402
from tpu_splatting.rasterizer import stream_kernels as jkern  # noqa: E402
from tpu_splatting_torch.rasterizer import stream as tstream  # noqa: E402
from tpu_splatting_torch.rasterizer import (  # noqa: E402
    stream_kernels as tkern)

TOL = dict(atol=1e-5, rtol=1e-5)

MODES = {
    "blend": dict(),
    "blend_antialias": dict(antialias=True),
    "quantile": dict(use_alpha_blending=False, saturate_threshold=0.25),
    "quantile_antialias": dict(use_alpha_blending=False,
                               saturate_threshold=0.25, antialias=True),
}


def scene(case):
  if case == "wide":
    packed, depths, feats, size = wide_scene()
    return packed, depths, feats, size, dict(wide_cap=64, dup_cap=512)
  packed, depths, feats = make_scene(0, 80, (32, 24))
  return (np.asarray(packed), np.asarray(depths), np.asarray(feats),
          (32, 24), {})


@pytest.mark.parametrize("case,mode", [
    ("tight", "blend"), ("tight", "blend_antialias"),
    ("tight", "quantile"), ("tight", "quantile_antialias"),
    ("wide", "blend")])
def test_twin_matches_reference(case, mode):
  packed, depths, feats, size, caps = scene(case)
  config = RasterConfig(tile_size=8, chunk_size=8, **MODES[mode])
  if not config.use_alpha_blending:
    feats = depths[:, None]          # the median pass composites depth
  # the mapping does not depend on the compositing mode: one compile
  map_cfg = RasterConfig(tile_size=8, chunk_size=8)
  mj = jstream.stream_map(jnp.asarray(packed, jnp.float32),
                          jnp.asarray(depths, jnp.float32),
                          jnp.asarray(feats, jnp.float32), size, map_cfg,
                          group_width=2, **TIGHT, **caps)
  assert int(mj.num_overflow) == 0
  want = np.asarray(jkern.stream_forward(mj, config))
  tcfg = pc.config(config)

  got_a = tkern.stream_forward(pc.mapping(mj), tcfg)        # JAX-built map
  mt = tstream.stream_map(pc.t(packed, torch.float32),
                          pc.t(depths, torch.float32),
                          pc.t(feats, torch.float32), size,
                          pc.config(map_cfg), group_width=2, **TIGHT, **caps)
  got_b = tkern.stream_forward(mt, tcfg)                    # port's map
  assert got_a.shape == want.shape and got_a.dtype == torch.float32
  assert float(np.abs(want).max()) > 0.1
  np.testing.assert_allclose(got_a.numpy(), want, **TOL)
  np.testing.assert_allclose(got_b.numpy(), want, **TOL)


def test_cpu_tensors_take_the_twin():
  """A CPU mapping goes to the twin and launches no kernel."""
  packed, depths, feats, size, _ = scene("tight")
  cfg = pc.config(RasterConfig(tile_size=8, chunk_size=8))
  m = tstream.stream_map(pc.t(packed), pc.t(depths), pc.t(feats), size, cfg,
                         group_width=2, **TIGHT)
  tkern.reset_launch_counts()
  out = tkern.stream_forward(m, cfg)
  assert tkern.launch_counts["stream_forward"] == 0
  torch.testing.assert_close(out, tkern.stream_forward_reference(m, cfg),
                             atol=0, rtol=0)
