"""Counterparts of the reference's benchmark probes (``benchmarks/``) that
hold hand-written kernels: each module is named after its reference
script."""
