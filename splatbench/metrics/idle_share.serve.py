"""The device's idle share of the traced serve ops (%): 1 - the kernel time
per op in the traced session / the op's time in the window."""
from splatbench.readers import idle_share as read  # noqa: F401
