"""Build and load the package's hand-written CUDA kernels.

Each kernel source under ``tpu_splatting_torch/csrc/`` has a plain C entry
point.  At first use it is compiled with ``nvcc`` for Hopper (``sm_90a``)
into ``tpu_splatting_torch/_build/`` (named by a hash of the source and
the shared headers, so an edited source rebuilds) and loaded with
``ctypes``.  Nothing is built at import time, and nothing here runs unless
a CUDA tensor reaches a kernel wrapper.

The compositing kernels' wrappers plan each launch here in plain Python
(``KernelPlan``: instantiation, threads, shared memory), so the CPU tests
can check every choice and ``chip_smoke.py`` can hold the shared-memory
formulas against the kernels' own ``*_smem`` entries.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import NamedTuple

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# -fmad=false: no mul+add contraction, so the kernels round like their
# plain-torch twins (threshold decisions then agree bit for bit)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

SMEM_LIMIT = 232448   # dynamic shared memory one block may use on Hopper

_locks_guard = threading.Lock()
_locks = {}      # one lock per source: different sources build in parallel
_libs = {}
# per source: {"seconds": build time (0.0 when already built), "log": ptxas}
build_info = {}


def _nvcc() -> str:
  for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
               "/usr/local/cuda/bin/nvcc"):
    if cand and os.path.exists(cand):
      return cand
  raise RuntimeError("nvcc not found: the CUDA kernels of tpu_splatting_torch "
                     "are built at first use and need the CUDA toolkit")


def load_kernel_library(source: str) -> ctypes.CDLL:
  """Compile ``csrc/<source>`` (once per source content) and load it.
  Thread-safe; calls for different sources run their ``nvcc`` in
  parallel."""
  with _locks_guard:
    lock = _locks.setdefault(source, threading.Lock())
  with lock:
    lib = _libs.get(source)
    if lib is not None:
      return lib
    path = os.path.join(CSRC, source)
    sha = hashlib.sha1(repr(NVCC_FLAGS).encode())
    # the source and every shared header it may include
    for name in [source] + sorted(n for n in os.listdir(CSRC)
                                  if n.endswith(".cuh")):
      with open(os.path.join(CSRC, name), "rb") as fh:
        sha.update(fh.read())
    digest = sha.hexdigest()
    stem = os.path.splitext(source)[0]
    so = os.path.join(BUILD_DIR, f"{stem}-{digest[:16]}.so")
    t0 = time.perf_counter()
    log = ""
    if not os.path.exists(so):
      os.makedirs(BUILD_DIR, exist_ok=True)
      tmp = f"{so}.{os.getpid()}.tmp"
      proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, path],
                            capture_output=True, text=True)
      if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {source}:\n{proc.stderr}")
      os.replace(tmp, so)
      log = proc.stderr
    build_info[source] = {"seconds": time.perf_counter() - t0, "log": log}
    lib = ctypes.CDLL(so)
    _libs[source] = lib
    return lib


def load_kernel_libraries(sources) -> dict:
  """Build and load several sources at once, one ``nvcc`` each."""
  from concurrent.futures import ThreadPoolExecutor
  with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
    return dict(zip(sources, pool.map(load_kernel_library, sources)))


class KernelPlan(NamedTuple):
  """How a compositing kernel is launched for one call's shapes."""
  max_features: int   # its register instantiation's most features; 0: generic
  threads: int        # threads a block
  smem: int           # dynamic shared memory of one block, bytes


# The register instantiations run tiles of whole warps of at most this many
# pixels; other tiles (tile_size 4, and above 16) take the generic one.
REGISTER_THREADS = 256


def block_threads(tile_area: int) -> int:
  """Threads of a block that holds one tile: its pixels in whole warps."""
  return -(-tile_area // 32) * 32


def acc_stride(rows: int) -> int:
  """Column stride of a shared [column][row] accumulator of ``rows`` rows
  (``acc_stride`` of ``csrc/kernel_common.cuh``)."""
  return ((rows + 31) & ~31) + 1


def instantiation(f: int, tile_area: int, widths) -> int:
  """The most features of the first register instantiation (``widths``,
  ascending) that holds ``f`` features, where the tile is whole warps of
  at most ``REGISTER_THREADS`` pixels; else 0: the generic instantiation,
  which keeps per-thread arrays in shared memory, takes any F, pads a tile
  to whole warps with frozen lanes and runs blocks of up to 1024
  threads."""
  if tile_area % 32 == 0 and tile_area <= REGISTER_THREADS:
    for w in widths:
      if f <= w:
        return w
  return 0


def check_smem(name: str, plan: KernelPlan, shapes: str):
  """ValueError where one block's shared memory cannot hold the plan."""
  if plan.smem > SMEM_LIMIT:
    raise ValueError(f"{name} kernel needs {plan.smem} B of shared memory a "
                     f"block ({shapes}); one block holds at most "
                     f"{SMEM_LIMIT} B")


def declare_plan_entries(lib: ctypes.CDLL, stem: str, smem_args: int):
  """Declare the C signatures of ``<stem>_smem`` (``smem_args`` ints) and
  ``<stem>_occupancy``."""
  smem = getattr(lib, f"{stem}_smem")
  smem.restype = ctypes.c_longlong
  smem.argtypes = [ctypes.c_int] * smem_args
  occ = getattr(lib, f"{stem}_occupancy")
  occ.restype = ctypes.c_int
  occ.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                  ctypes.POINTER(ctypes.c_int)]


def occupancy(lib: ctypes.CDLL, stem: str, plan: KernelPlan) -> dict:
  """Resident blocks and warps per SM, registers and local (stack and
  spill) bytes a thread of the plan's instantiation, from the CUDA
  runtime (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
  out = (ctypes.c_int * 3)()
  err = getattr(lib, f"{stem}_occupancy")(plan.max_features, plan.threads,
                                          plan.smem, out)
  if err != 0:
    raise RuntimeError(f"{stem}_occupancy: CUDA error {err}")
  return {"blocks_per_sm": out[0], "warps_per_sm": out[0] * plan.threads // 32,
          "registers": out[1], "local_bytes": out[2]}


@contextlib.contextmanager
def launch_stream(dev: torch.device):
  """Make ``dev`` the current device for one kernel launch and yield the
  handle (a ``cudaStream_t``) of its current stream."""
  with torch.cuda.device(dev):
    yield torch.cuda.current_stream(dev).cuda_stream
