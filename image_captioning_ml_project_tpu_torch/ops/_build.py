"""Build the port's CUDA sources into shared libraries loaded with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled at
first use with ``nvcc`` for ``sm_90a`` (Hopper), from the package's own
sources only, into ``_build/`` beside this package (listed in
``.gitignore``). The library's file name carries a hash of the sources and
the flags, so an edited source rebuilds and a fresh checkout builds on its
first run. A failed build raises with nvcc's stderr; nothing falls back.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default location; raises if none exists."""
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for cand in candidates:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the port's CUDA kernels")


def _sources(name: str):
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    if not os.path.exists(src):
        raise FileNotFoundError(src)
    return [src] + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def library_path(name: str) -> str:
    """Where the build of ``csrc/<name>.cu`` at its current sources goes."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(name):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def _compile(src: str, so: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{os.path.basename(src)}:\n{proc.stderr}")
    with open(so[:-3] + ".log", "w") as f:  # ptxas resource usage
        f.write(proc.stderr)
    os.replace(tmp, so)


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its hashed library is missing, then load
    it (once per process)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            src = _sources(name)[0]
            so = library_path(name)
            if not os.path.exists(so):
                _compile(src, so)
            lib = ctypes.CDLL(so)
            _libs[name] = lib
        return lib


def build_log(name: str) -> str:
    """ptxas's ``-v`` report (registers, shared memory, spills) from
    the build of ``csrc/<name>.cu``, or '' if it was built elsewhere."""
    log = library_path(name)[:-3] + ".log"
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return f.read()
