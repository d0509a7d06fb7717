"""K2's (stream_backward*) share of its roofline in the training step (%)."""
from splatbench.readers import k2_roofline as read  # noqa: F401
