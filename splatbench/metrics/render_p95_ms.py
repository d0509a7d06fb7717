"""The 95th percentile of the window's view latencies (ms): each from when
the view was due to the synchronise after it (host clock)."""

from splatbench import harness


def read(ctx):
  return harness.quantile95(ctx["latency_ms"]) if ctx["latency_ms"] else None
