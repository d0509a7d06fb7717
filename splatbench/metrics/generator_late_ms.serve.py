"""How late the open loop's generator ran (ms): the most by which a
view started after it was due, or after the view before it was done where
that came later (host clock)."""


def read(ctx):
  return max(ctx["late_ms"]) if ctx["late_ms"] else None
