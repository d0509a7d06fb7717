"""K2 and the gradient reduce's ms per training step: the program's
``backward.raster`` span (``_StreamRaster.backward``), by its CUDA events,
in the spans window."""
from splatbench.spans import span_ms


def read(ctx):
  return span_ms(ctx, "backward.raster")
