"""The device's idle ms per view while the host was in
``stream_map``: the ``map`` span's events in the spans window less the
busy time of the records launched under ``map`` in the session."""
from splatbench.spans import map_idle_ms as read  # noqa: F401
