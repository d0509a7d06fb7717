"""Projection and SH shading's ms per training step: the program's
``project`` and ``sh`` spans, by their CUDA events, in the spans window."""
from splatbench.spans import span_ms


def read(ctx):
  return span_ms(ctx, "project", "sh")
