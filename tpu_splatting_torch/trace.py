"""Named spans and host-sync counts inside the program.

Tracing is off by default, and then ``span(name)`` costs one flag test: it
returns a shared no-op context and creates no profiler range, CUDA event or
tensor hook.  ``enable()`` turns it on for the whole process; then each span

* opens a profiler range named ``"ts." + name`` (``torch.profiler.
  record_function``'s, or its cheaper form where torch has it), so in any
  ``torch.profiler`` session the span lies on the same timeline as the
  kernels launched inside it (a Chrome trace shows it as a range);
* records a pair of CUDA events on the stream current at its start (the
  host clock without CUDA) and the host time;
* counts the host syncs made inside it (``torch.cuda.set_sync_debug_mode
  ("warn")`` while tracing is on; each warning is charged to the innermost
  open span of the thread that made it, or where that thread has none, to
  the span entered last on any thread).  Syncs made inside the autograd
  engine's C++ nodes raise no Python warning and are not counted.

``count(**values)`` adds integer device scalars (or plain numbers) to the
innermost open span of the thread: they are kept as they are, with no
host sync, and ``summary()`` sums them over the span's calls at the sync
it makes anyway.  A value that would take a kernel to make is passed as a
zero-argument callable, run only while tracing is on.  Off, it records
nothing.

The span stack is per thread: the autograd engine runs a custom
``backward`` on a thread of its own.  ``grad_span(tensor, name)`` opens a
span when the backward pass reaches ``tensor``'s gradient; it lasts until
the next such span opens on that thread or the backward pass ends.

Spans of the program: ``project``, ``sh``, ``map`` (with ``map.bounds``,
``map.wide_dup``, ``map.sort``, ``map.edges``, ``map.strips``,
``map.descriptors``, ``map.grad_gather``), ``k1``, ``backward`` (the
``torch.autograd.grad`` of ``render_with_heuristics``), ``backward.raster``
(K2 and the reduce), ``backward.sh`` and ``backward.project`` (from the
gradient of the SH colours and of the projected splats on), and
``optimizer``.  Counts: ``map.wide_dup``'s ``wide`` (the mapping's wide
splats, those that reach past the 3x3 tiles about their home) and
``dup_rows`` (the duplicate rows it made for them); K2's, in the span its
launch falls in (``backward.raster`` in a training step), ``k2_chunks``
(the chunks a full slab takes, ``ceil(slab_cap / chunk)``) and
``k2_blocks_per_sm`` (its plan's resident blocks an SM), both host
integers, summed over the launches.

In one's own trainer::

    from tpu_splatting_torch import trace
    trace.enable()
    for _ in range(20):
      step()
    for name, s in trace.summary().items():
      print(name, s)      # calls, device_ms, host_ms (per call), syncs
    trace.disable()

``summary()`` synchronises the device once; call it after the steps, not
inside them.  Under ``examples/fit_image_gaussians --profile`` with tracing
on, the spans show in its Chrome trace as ``ts.*`` ranges.
"""

from __future__ import annotations

import contextlib
import threading
import time
import warnings

import torch

PREFIX = "ts."
_SYNC_MESSAGE = "synchronizing CUDA operation"
# a profiler range at a tenth of ``record_function``'s host cost, where
# this torch has it
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast",
                 torch.profiler.record_function)

_on = False
_cuda = False
_saved = None             # (showwarning, sync mode, warnings filter)
_stacks = {}              # thread id -> its open spans, innermost last
_open = []                # every open span, in the order entered
_phases = []              # open spans that grad_span opened
_totals = {}              # name -> [calls, host s, syncs, device ms]
_pending = []             # (name, start event, end event), not yet read
_pending_counts = []      # (name, {key: device scalar or number})
_counts = {}              # name -> {key: sum read so far}
_lock = threading.Lock()  # the counts are shared by every thread


_OFF = contextlib.nullcontext()


class _Span:
  __slots__ = ("name", "range", "stream", "start", "t0", "syncs", "thread")

  def __init__(self, name: str):
    self.name = name

  def __enter__(self):
    self.thread = threading.get_ident()
    self.syncs = 0
    self.range = _RANGE(PREFIX + self.name)
    self.range.__enter__()
    if _cuda:
      self.stream = torch.cuda.current_stream()
      self.start = torch.cuda.Event(enable_timing=True)
      self.start.record(self.stream)
    self.t0 = time.perf_counter()
    _totals.setdefault(self.name, [0, 0.0, 0, 0.0])
    _stacks.setdefault(self.thread, []).append(self)
    _open.append(self)
    return self

  def __exit__(self, *exc):
    self.close()
    return False

  def close(self):
    host_s = time.perf_counter() - self.t0
    if _cuda:
      end = torch.cuda.Event(enable_timing=True)
      end.record(self.stream)
      _pending.append((self.name, self.start, end))
    self.range.__exit__(None, None, None)
    _stacks[self.thread].remove(self)
    _open.remove(self)
    if self in _phases:
      _phases.remove(self)
    with _lock:
      total = _totals.setdefault(self.name, [0, 0.0, 0, 0.0])
      total[0] += 1
      total[1] += host_s
      total[2] += self.syncs
      if not _cuda:
        total[3] += host_s * 1e3


def span(name: str):
  """A context manager: the named span while tracing is on, else a no-op."""
  if not _on:
    return _OFF
  return _Span(name)


def count(**values) -> None:
  """While tracing is on, add each value (an integer device scalar, a
  number, or a zero-argument callable giving one, called only then) to
  the innermost open span of this thread; ``summary()`` gives their sums
  under the span's ``"counts"``.  Nothing outside a span."""
  if not _on:
    return
  stack = _stacks.get(threading.get_ident())
  if stack:
    values = {k: v() if callable(v) else v for k, v in values.items()}
    with _lock:
      _pending_counts.append((stack[-1].name, values))


def grad_span(tensor: torch.Tensor, name: str) -> None:
  """While tracing is on, make the backward pass open span ``name`` when
  it reaches ``tensor``'s gradient (a hook that leaves the gradient as it
  is); nothing when tracing is off or ``tensor`` needs no gradient."""
  if not _on or not tensor.requires_grad:
    return
  tensor.register_hook(lambda grad: _open_phase(name))


def _open_phase(name: str):
  if not _on:
    return
  stack = _stacks.get(threading.get_ident())
  if stack and stack[-1] in _phases:
    stack[-1].close()
  if not _phases:
    torch.autograd.Variable._execution_engine.queue_callback(_close_phases)
  phase = _Span(name)
  phase.__enter__()
  _phases.append(phase)


def _close_phases():
  """Runs when the backward pass ends."""
  for phase in list(_phases):
    phase.close()


def _on_warning(message, category, filename, lineno, file=None, line=None):
  if _SYNC_MESSAGE not in str(message):
    _saved[0](message, category, filename, lineno, file, line)
    return
  stack = _stacks.get(threading.get_ident())
  owner = stack[-1] if stack else (_open[-1] if _open else None)
  if owner is not None:
    with _lock:
      owner.syncs += 1


def enable() -> None:
  """Turn tracing on (counting host syncs where CUDA is available)."""
  global _on, _cuda, _saved
  if _on:
    return
  _cuda = torch.cuda.is_available()
  if _cuda:
    warnings.filterwarnings("always", message=".*" + _SYNC_MESSAGE)
    _saved = (warnings.showwarning, torch.cuda.get_sync_debug_mode(),
              warnings.filters[0])
    warnings.showwarning = _on_warning
    torch.cuda.set_sync_debug_mode("warn")
  _on = True


def disable() -> None:
  """Turn tracing off; what it recorded stays for ``summary()``."""
  global _on, _saved
  if not _on:
    return
  _on = False
  if _saved is not None:
    showwarning, mode, entry = _saved
    torch.cuda.set_sync_debug_mode(mode)
    warnings.showwarning = showwarning
    if entry in warnings.filters:
      warnings.filters.remove(entry)
      warnings._filters_mutated()
    _saved = None


def reset() -> None:
  """Forget what the closed spans recorded."""
  _totals.clear()
  _pending.clear()
  _pending_counts.clear()
  _counts.clear()


def _read_counts() -> None:
  """Fold the pending counts into ``_counts``: the device scalars of each
  device read in one copy."""
  by_device = {}
  for name, values in _pending_counts:
    sums = _counts.setdefault(name, {})
    for key, v in values.items():
      sums.setdefault(key, 0)
      if isinstance(v, torch.Tensor):
        by_device.setdefault(v.device, []).append((sums, key, v))
      else:
        sums[key] += v
  for items in by_device.values():
    read = torch.stack([v.reshape(()).to(torch.int64)
                        for _, _, v in items]).tolist()
    for (sums, key, _), v in zip(items, read):
      sums[key] += v
  _pending_counts.clear()


def summary() -> dict:
  """{span name: {"calls", "device_ms", "host_ms", "syncs"[, "counts"]}},
  in the order the spans were first entered: ``device_ms`` and ``host_ms``
  the mean per call (``device_ms`` from the CUDA events, which also hold
  the device's waits for the host; the host clock without CUDA),
  ``syncs`` the host syncs made inside the span and not inside a span
  within it, over all calls; ``counts`` ({key: sum over all calls}) where
  ``count`` was called inside the span."""
  if _pending:
    torch.cuda.synchronize()
    for name, start, end in _pending:
      _totals[name][3] += start.elapsed_time(end)
    _pending.clear()
  if _pending_counts:
    _read_counts()
  out = {name: {"calls": calls, "device_ms": dev_ms / calls,
                "host_ms": host_s * 1e3 / calls, "syncs": syncs}
         for name, (calls, host_s, syncs, dev_ms) in _totals.items()
         if calls}
  for name, sums in _counts.items():
    if name in out:
      out[name]["counts"] = dict(sums)
  return out
