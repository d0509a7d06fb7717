"""Faults planted in the program, for the check of ``correct`` to catch:
a step that returns its state unchanged, half of the splats left out (the
sums of the rest doubled), an answer altered where it is produced.  (One
card: no exchange between chips to leave out.)  Each takes a
``setattr(obj, name, value)``, pytest's ``monkeypatch.setattr`` or
``planted``'s, which puts everything back afterwards.  The benchmark's
runs never plant one."""

from __future__ import annotations

import contextlib
import dataclasses

import tpu_splatting_torch as ts
from tpu_splatting_torch import optim


def _without_half(g3d):
  """The odd splats made invisible (left out of the render)."""
  alpha = g3d.alpha_logit.clone()
  alpha[1::2] = -100.0
  return g3d.replace(alpha_logit=alpha)


def state_unchanged(setattr_):
  setattr_(optim.VisibilityAwareAdam, "step",
           lambda self, params, grads, state, vis, **kw: (params, state))


def half_left_out(setattr_):
  render, heur, smap = (ts.render_gaussians, ts.render_with_heuristics,
                        ts.stream_map)

  def render_half(g3d, *a, **kw):
    return render(_without_half(g3d), *a, **kw)

  def heur_half(loss_fn, g3d, *a, **kw):
    loss, rendering, grads = heur(loss_fn, _without_half(g3d), *a, **kw)
    return 2 * loss, rendering, dataclasses.replace(
        grads, **{f.name: 2 * getattr(grads, f.name)
                  for f in dataclasses.fields(grads)})

  def map_half(packed, *a, **kw):
    packed = packed.clone()
    packed[1::2, 6] = 0.0
    return smap(packed, *a, **kw)
  setattr_(ts, "render_gaussians", render_half)
  setattr_(ts, "render_with_heuristics", heur_half)
  setattr_(ts, "stream_map", map_half)


def answer_altered(setattr_):
  render, heur, raster = (ts.render_gaussians, ts.render_with_heuristics,
                          ts.stream_rasterize_with_mapping)

  def render_altered(*a, **kw):
    r = render(*a, **kw)
    image = r.image.clone()
    image[:16, :16] += 0.5
    return r.replace(image=image)

  def heur_altered(*a, **kw):
    loss, rendering, grads = heur(*a, **kw)
    return loss * 1.001, rendering, grads

  def raster_altered(*a, **kw):
    return raster(*a, **kw) * 1.001
  setattr_(ts, "render_gaussians", render_altered)
  setattr_(ts, "render_with_heuristics", heur_altered)
  setattr_(ts, "stream_rasterize_with_mapping", raster_altered)


FAULTS = {f.__name__: f for f in (state_unchanged, half_left_out,
                                  answer_altered)}


def applies(fault, cell: str) -> bool:
  """A serving cell has no state to leave unchanged."""
  return not (fault is state_unchanged and cell.startswith("view"))


@contextlib.contextmanager
def planted(name: str):
  """The fault ``name`` planted for the ``with`` block."""
  saved = []

  def setattr_(obj, attr, value):
    saved.append((obj, attr, getattr(obj, attr)))
    setattr(obj, attr, value)
  try:
    FAULTS[name](setattr_)
    yield
  finally:
    for obj, attr, value in reversed(saved):
      setattr(obj, attr, value)
