"""Device records (kernels, copies, fills) per view in the traced session
with the program's spans on."""
from splatbench.spans import launches as read  # noqa: F401
