"""``stream_map``'s ms per view: the program's ``map`` span, by its CUDA
events, in the spans window."""
from splatbench.spans import span_ms


def read(ctx):
  return span_ms(ctx, "map")
