"""The duplicate rows per view that the stream mapper's wide path made:
the program's ``map.wide_dup`` counter (``dup_rows``), summed over the
spans window's views.  None where the program counts nothing there."""
from splatbench.spans import reading


def read(ctx):
  spans, _ = reading(ctx)
  if spans is None:
    return None
  counts = spans["summary"].get("map.wide_dup", {}).get("counts", {})
  if "dup_rows" not in counts:
    return None
  return counts["dup_rows"] / spans["ops"]
