"""The autograd tail's ms per training step: the program's
``backward.sh`` and ``backward.project`` spans (from where autograd
reaches the SH colours' and the projected splats' gradients to the end of
the backward), by their CUDA events, in the spans window."""
from splatbench.spans import span_ms


def read(ctx):
  return span_ms(ctx, "backward.sh", "backward.project")
