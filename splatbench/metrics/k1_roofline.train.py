"""K1's (stream_forward*) share of its roofline in the train op (%)."""
from splatbench.readers import k1_roofline as read  # noqa: F401
