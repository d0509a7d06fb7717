"""Host syncs per view, counted by the program's spans in the spans
window."""
from splatbench.spans import host_syncs as read  # noqa: F401
