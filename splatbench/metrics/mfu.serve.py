"""The whole serve op's share of the card's f32 peak (%): the harness's
operation count over the op's time by the window."""
from splatbench.readers import mfu as read  # noqa: F401
