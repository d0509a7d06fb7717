"""The mapper's window-descriptor kernel alone, beside its plain twin.

    python -m tpu_splatting_torch.benchmarks.bench_descriptors
        [--device cuda|cpu] [--scene heavy|uniform] [--gw 8] [--iters 20]
        [--n N] [--size W H]

The scene is the bench's (``bench.scene_arrays``), calibrated through the
bench's cache and mapped once (``diagnostics.prepare``); that ``stream_map``
call's ``stream_descriptors`` inputs and output are recorded, the output
held to the twin on the same inputs, and then each of
``stream_kernels.stream_descriptors`` (``csrc/stream_map.cu`` on the card)
and ``stream.stream_descriptors_reference`` (the twin: the band-local edge
slices and ``_desc_pipeline`` over group chunks, on the same device) is
timed on them (``diagnostics.timed``).  On the card the kernel's line also
gives its byte bound (the descriptor table written, the cell-edge table
and strip blocks read once, at 3.35 TB/s) and its device time's share of
it, and its resident warps per SM, registers and shared memory.  The first
line says whether the map's descriptors equal the twin's, bit for bit.
"""

from __future__ import annotations

import contextlib
import sys

import torch

from ..rasterizer import stream as st
from ..rasterizer import stream_kernels as sk
from . import diagnostics as dg

HBM_BYTES_PER_S = 3.35e12


@contextlib.contextmanager
def recorded_calls():
  """Every ``stream_descriptors`` call made inside the block, in order, as
  (edges_all, strip_blk, kw, (desc, over)).  ``stream_map`` looks the
  wrapper up in ``stream_kernels`` at each call, so this sees them all."""
  calls = []
  wrapper = sk.stream_descriptors

  def record(edges_all, strip_blk, **kw):
    out = wrapper(edges_all, strip_blk, **kw)
    calls.append((edges_all, strip_blk, kw, out))
    return out
  sk.stream_descriptors = record
  try:
    yield calls
  finally:
    sk.stream_descriptors = wrapper


def bound_bytes(edges_all, strip_blk, kw) -> int:
  """Bytes the descriptors need: the table written, the cell edges and
  strip blocks read once."""
  g = strip_blk.shape[0]
  desc = g * kw["group_width"] * kw["num_slabs"] * kw["w_max"] * 16
  return desc + 8 * edges_all.numel() + 8 * strip_blk.numel()


def run(s, opts: dg.Opts) -> dict:
  """The scene's ``stream_map`` call once, its one descriptor call's
  output held to the twin on the same inputs, then both timed.  Returns
  {"kernel": Timing, "twin": Timing, "equal": bool, "kw": the call's
  shapes and capacities, "launches": the map's kernel launches,
  "bound_bytes"; on the card also "plan" and "occupancy"}; prints a line
  each."""
  sk.reset_launch_counts()
  with recorded_calls() as calls:
    s.map_f(*s.map_args)
  assert len(calls) == 1, len(calls)
  edges_all, strip_blk, kw, got = calls[0]
  out = {"kw": kw, "launches": sk.launch_counts["stream_descriptors"],
         "bound_bytes": bound_bytes(edges_all, strip_blk, kw)}
  want = st.stream_descriptors_reference(edges_all, strip_blk, **kw)
  out["equal"] = all(torch.equal(a, b) for a, b in zip(got, want))
  print(f"kernel equals twin: {out['equal']} (desc {tuple(got[0].shape)}, "
        f"overflow {got[1].tolist()}; {kw})", flush=True)
  del calls, got, want
  call = lambda e, b: sk.stream_descriptors(e, b, **kw)
  twin = lambda e, b: st.stream_descriptors_reference(e, b, **kw)
  on_card = edges_all.is_cuda
  note = ""
  if on_card:
    from ..utils.cuda_build import occupancy
    plan = sk.stream_descriptors_plan(kw["group_width"], kw["num_slabs"],
                                      kw["w_max"])
    occ = occupancy(sk._map_kernel(), "tpu_splat_stream_descriptors", plan)
    out.update(plan=plan, occupancy=occ)
    nbytes = out["bound_bytes"]
    note = (f"bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({nbytes} B); "
            f"{occ['warps_per_sm']} warps resident per SM "
            f"({occ['blocks_per_sm']} blocks of {plan.threads} threads, "
            f"{occ['registers']} registers, {occ['local_bytes']} local "
            f"bytes, {plan.smem} B of shared memory)")
  out["kernel"] = dg.timed("descriptors kernel", call,
                           (edges_all, strip_blk), opts, note)
  if on_card and out["kernel"].device_ms is not None:
    share = nbytes / HBM_BYTES_PER_S * 1e3 / out["kernel"].device_ms
    print(f"kernel device time at {share:.1%} of its byte bound", flush=True)
  out["twin"] = dg.timed("descriptors twin", twin, (edges_all, strip_blk),
                         opts)
  return out


def main(argv=None) -> int:
  p = dg.parser(__doc__, iters=20)
  dg.scene_options(p, gw=8, scene="heavy")
  args = p.parse_args(argv)
  out = run(dg.prepare(args.scene, args, dg.start(args)),
            dg.Opts.of(args))
  return 0 if out["equal"] else 1


if __name__ == "__main__":
  sys.exit(main())
