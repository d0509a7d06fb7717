"""What the per-layer metrics' readers (``metrics/<name>.py``) share.

A reader takes the run's context (``run.py``: ``op_ms``, ``calibrate_s``,
``timer``, ``latency_ms``, ``late_ms``, and in a traced run ``work``, the harness's own counts, and on
a card ``session``, the profiler's reading) and returns a number, or None
where its run has nothing for it to read.
"""

from __future__ import annotations

from . import roofline


def kernel_seconds(ctx, prefix: str):
  """Device seconds per op of the kernels whose name holds ``prefix``."""
  session = ctx.get("session")
  if session is None:
    return None
  total = sum(s for name, s in session["kernels"].items() if prefix in name)
  if total <= 0:
    return None
  return total / session["ops"]


def k1_roofline(ctx):
  seconds = kernel_seconds(ctx, "stream_forward")
  if seconds is None:
    return None
  w = ctx["work"]
  least = roofline.least_seconds(
      w["pairs"] * roofline.PIXELS * roofline.k1_ops_per_pair(w["features"]),
      roofline.k1_bytes(w["pairs"], w["tiles"], w["features"]))
  return roofline.share(least, seconds)


def k2_roofline(ctx):
  seconds = kernel_seconds(ctx, "stream_backward")
  if seconds is None:
    return None
  w = ctx["work"]
  least = roofline.least_seconds(
      w["pairs"] * roofline.PIXELS * roofline.k2_ops_per_pair(w["features"]),
      roofline.k2_bytes(w["pairs"], w["tiles"], w["features"]))
  return roofline.share(least, seconds)


def idle_share(ctx):
  """1 - the device's busy time per op in the traced session / the op's
  time in the window (a step: the window over the steps; a view: its mean
  service time), in %.  The busy time per op holds steady from session to
  session; the session's own few-op window reads the host's jitter."""
  session = ctx.get("session")
  if session is None:
    return None
  busy_ms = 1e3 * session["busy_s"] / session["ops"]
  return 100.0 * (1.0 - busy_ms / ctx["op_ms"])


def mfu(ctx):
  """The step's operations over its time by the window, against the f32
  peak, in %."""
  if "work" not in ctx or ctx.get("session") is None:
    return None
  return 100.0 * ctx["work"]["ops"] / (ctx["op_ms"] / 1e3) / \
      roofline.PEAK_F32_OPS
