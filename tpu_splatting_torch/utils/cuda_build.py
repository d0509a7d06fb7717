"""Build and load the package's hand-written CUDA kernels.

Each kernel source under ``tpu_splatting_torch/csrc/`` has a plain C entry
point.  At first use it is compiled with ``nvcc`` for Hopper (``sm_90a``)
into ``tpu_splatting_torch/_build/`` (named by a hash of the source, so an
edited source rebuilds) and loaded with ``ctypes``.  Nothing is built at
import time, and nothing here runs unless a CUDA tensor reaches a kernel
wrapper.
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

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# -fmad=false: no mul+add contraction, so the kernels round like their
# plain-torch twins (threshold decisions then agree bit for bit)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

CUDA_ERROR_INVALID_VALUE = 1    # cudaErrorInvalidValue, as the entries return it

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
    with open(path, "rb") as fh:
      digest = hashlib.sha1(fh.read() + repr(NVCC_FLAGS).encode()).hexdigest()
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


@contextlib.contextmanager
def launch_stream(dev: torch.device):
  """Make ``dev`` the current device for one kernel launch and yield the
  handle (a ``cudaStream_t``) of its current stream."""
  with torch.cuda.device(dev):
    yield torch.cuda.current_stream(dev).cuda_stream
