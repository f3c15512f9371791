"""Build the port's hand-written CUDA kernels and load them with ctypes.

Each kernel source in ``ops/csrc/`` has a plain C interface, so it is
compiled by ``nvcc`` alone into a shared library (no PyTorch headers: a
build takes seconds, not minutes) and bound with ``ctypes``. Libraries go
to ``build/torch_kernels/`` beside the package, named by a hash of the
source and flags, so an edited source never loads a stale build.

Builds happen at first use (``library``), or all at once with ``build_all``,
which starts one ``nvcc`` per source in parallel. A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

# kernel library name -> its sources under csrc/
SOURCES: Dict[str, List[str]] = {"compact": ["compact.cu"],
                                  "hashpart": ["hashpart.cu"],
                                  "segagg": ["segagg.cu"],
                                  "segscan": ["segscan.cu"],
                                  "vecsearch": ["vecsearch.cu"]}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built on the machine with the card")
    return found


def _target(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES[name]:
        with open(os.path.join(CSRC, src), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def _start(name: str) -> Optional[subprocess.Popen]:
    """Start nvcc for ``name`` unless its library is already built."""
    so = _target(name)
    if os.path.exists(so):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", so + ".tmp",
           *[os.path.join(CSRC, s) for s in SOURCES[name]]]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: Optional[subprocess.Popen]) -> str:
    """Wait for a build started by _start; returns the compiler's log
    (ptxas register and shared-memory use), saved beside the library so a
    cached build returns it too, and raises if the build failed."""
    so = _target(name)
    if proc is None:
        with open(so + ".log") as fh:
            return fh.read()
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(exit {proc.returncode}):\n{log}")
    with open(so + ".log", "w") as fh:      # before the library appears
        fh.write(log)
    os.replace(so + ".tmp", so)
    return log


def build_all() -> Dict[str, str]:
    """Build every kernel library, one nvcc per library, all started
    together; returns {name: compiler log}."""
    # one nvcc a library a process, by design: a caller of a kernel
    # waits for its build under _LOCK, and nothing else contends on it
    with _LOCK:
        procs = {name: _start(name) for name in SOURCES}  # concur: ok CC202
        return {name: _finish(name, p)  # concur: ok CC202
                for name, p in procs.items()}


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name``, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                _finish(name, _start(name))  # concur: ok CC202
                lib = _LIBS[name] = ctypes.CDLL(_target(name))
    return lib
