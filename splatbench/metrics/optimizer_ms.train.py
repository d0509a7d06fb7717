"""The optimizer step's ms, by CUDA events around the harness's own
``opt.step`` call, the mean over the window's steps."""


def read(ctx):
  return ctx["timer"].ms("optimizer")
