"""The seconds of the harness's calibration over the cell's poses or input
sets (host clock, with a synchronise)."""


def read(ctx):
  return ctx["calibrate_s"]
