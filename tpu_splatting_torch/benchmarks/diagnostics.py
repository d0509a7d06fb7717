"""Shared pieces of the diagnostic scripts: the counterparts of
``benchmarks/profile_*.py`` and ``benchmarks/exp_{mapper,reduce,
rowgather,layout,precision}.py``.

Each script is ``main(argv=None) -> int`` with ``--device cuda|cpu``
(default ``cuda``; without a card it raises unless ``--device cpu``) and
prints one line per label of its reference script, ``label: ...``.  On
the card a timed line gives the call's time by CUDA events
(``utils.benchmarked``) and, from a ``torch.profiler`` session of two
calls that kept every kernel record (``device_reading``), the device's
busy time, the kernels launched and the busy share.  On the CPU the
times are the host clock's, of the plain twins, and no device number is
given.  A
mapping that drops rows is an error: ``check_overflow`` raises, and the
script exits 1.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, Optional

import torch

from .. import bench
from ..rasterizer.stream import W_MAX_LIMIT
from ..utils.benchmarked import _on_cuda, benchmarked, profiled_kernels


def parser(doc: str, iters: int) -> argparse.ArgumentParser:
  """The scripts' common options: ``--device`` and ``--iters``."""
  p = argparse.ArgumentParser(description=doc.split("\n")[0])
  p.add_argument("--device", default="cuda",
                 help="cuda (the default) or cpu (the plain twins)")
  p.add_argument("--iters", type=int, default=iters,
                 help="timed calls per label")
  p.add_argument("--warmup", type=int, default=2,
                 help="untimed calls before them")
  return p


def scene_options(p: argparse.ArgumentParser, gw: int,
                  scene: Optional[str] = None):
  """``--gw``, ``--n`` and ``--size`` (the bench's 2M splats at
  2048x1536 by default), and ``--scene`` where a default is given."""
  if scene is not None:
    p.add_argument("--scene", default=scene, choices=sorted(bench.SCENES))
  p.add_argument("--gw", type=int, default=gw, help="stream group width")
  p.add_argument("--n", type=int, default=bench.N, help="splats")
  p.add_argument("--size", type=int, nargs=2, default=bench.IMAGE_SIZE,
                 metavar=("W", "H"), help="image size")


def prepare(scene: str, args, dev) -> bench.SceneSetup:
  """The bench's 2D scene at ``args.n`` and ``args.size``, calibrated at
  ``args.gw`` through the bench's cache and mapped
  (``bench.prepare_scene``: dropped rows raise)."""
  size = tuple(args.size)
  return bench.prepare_scene(scene, *bench.to_device(
      dev, *bench.scene_arrays(scene, args.n, size)), size, args.gw)


def start(args) -> torch.device:
  """The device to run on (a CUDA device without a card raises), its
  card line printed first."""
  dev = bench.device_of(args.device)
  print(bench.card_line(dev), flush=True)
  return dev


@dataclasses.dataclass
class Timing:
  """One label's reading.  ``device_ms``, ``kernels`` and ``busy`` are
  None off the card."""
  ms: float
  device_ms: Optional[float] = None
  kernels: Optional[int] = None
  busy: Optional[float] = None

  def line(self) -> str:
    if self.device_ms is None:
      return f"{self.ms:.3f} ms (host clock, cpu twins)"
    return (f"{self.ms:.3f} ms by events, device {self.device_ms:.3f} ms in "
            f"{self.kernels} kernels, busy {self.busy:.1%}")


@dataclasses.dataclass(frozen=True)
class Opts:
  """Calls per label: ``iters`` timed after ``warmup`` untimed."""
  iters: int = 3
  warmup: int = 2

  @staticmethod
  def of(args) -> "Opts":
    return Opts(args.iters, args.warmup)


def timed(label: str, f: Callable, args, opts: Opts,
          note: str = "") -> Timing:
  """``f(*args)`` timed by ``utils.benchmarked``; on the card also its
  ``device_reading``.  Prints ``label: <reading>[; note]``."""
  ms = benchmarked(label, f, args, iters=opts.iters, warmup=opts.warmup)
  t = Timing(ms)
  reading = device_reading(lambda: f(*args)) if _on_cuda(args) else None
  if reading is not None:
    t.device_ms, t.kernels = reading
    t.busy = t.device_ms / ms
  line = t.line() if reading or not _on_cuda(args) else (
      f"{ms:.3f} ms by events, device time not measured (the profiler "
      "lost kernel records)")
  print(f"{label}: {line}" + (f"; {note}" if note else ""), flush=True)
  return t


def device_reading(fn, reps: int = 2, attempts: int = 2):
  """(device ms, kernels) of one ``fn()`` from a profiler session of
  ``reps`` calls (``utils.benchmarked.profiled_kernels``) in which every
  kernel ran a whole multiple of ``reps`` times; a session that lost
  records is run again, up to ``attempts`` times; then None."""
  fn()
  for _ in range(attempts):
    us, count = profiled_kernels(fn, reps, host=False)
    if count and all(c % reps == 0 for c in count.values()):
      return sum(us.values()) / reps / 1e3, sum(count.values()) // reps
  return None


def restated(label: str, why: str):
  """The line of a label whose TPU question does not carry over: why,
  and the H100 question that replaces it."""
  print(f"{label}: restated: {why}", flush=True)


def check_overflow(label: str, overflow: torch.Tensor,
                   ok: bool = False) -> list:
  """A mapping's overflow by cause (``StreamMapping.overflow``) as a
  list; dropped rows raise unless ``ok`` (a variant the reference labels
  "overflow ok")."""
  by_cause = overflow.tolist()
  if sum(by_cause) and not ok:
    raise RuntimeError(f"{label}: benchmark invalid, {sum(by_cause)} rows "
                       f"dropped (by cause {by_cause})")
  return by_cause


def held_caps(caps: dict, over: dict, cal: dict):
  """``caps`` updated by a variant's ``over``, where a count that the
  calibration ``cal`` found too small for the scene (``num_slabs``,
  ``w_max``) is raised instead: to twice the calibrated slabs, or to the
  largest ``w_max`` the mapper takes.  Returns (caps, what was raised)."""
  kw, raised = {**caps, **over}, []
  if kw["num_slabs"] < cal["num_slabs"]:
    raised.append(f"num_slabs {kw['num_slabs']} -> {2 * cal['num_slabs']} "
                  f"(the scene needs {cal['num_slabs']})")
    kw["num_slabs"] = 2 * cal["num_slabs"]
  if kw["w_max"] < cal["w_max"]:
    raised.append(f"w_max {kw['w_max']} -> {W_MAX_LIMIT} (the scene needs "
                  f"{cal['w_max']})")
    kw["w_max"] = W_MAX_LIMIT
  return kw, raised
