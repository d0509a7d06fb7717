"""``stream_map``'s ms, by CUDA events around the harness's own call (the
2D step calls it directly), the mean over the window's steps."""


def read(ctx):
  return ctx["timer"].ms("map")
