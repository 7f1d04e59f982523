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


def _start(src: str, so: str):
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, tmp


def _finish(src: str, so: str, proc, tmp: str) -> None:
    try:
        _, err = proc.communicate(timeout=900)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise RuntimeError(f"nvcc timed out building {os.path.basename(src)}")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{os.path.basename(src)}:\n{err}")
    with open(so[:-3] + ".log", "w") as f:  # ptxas resource usage
        f.write(err)
    os.replace(tmp, so)


def build_libraries(names) -> None:
    """Build every ``csrc/<name>.cu`` of ``names`` whose hashed library is
    missing: one nvcc process per source, all started together. Raises on
    the first failed build, after every process has ended."""
    with _lock:
        jobs = []
        for name in names:
            src, so = _sources(name)[0], library_path(name)
            if not os.path.exists(so):
                jobs.append((src, so, *_start(src, so)))
        errors = []
        for src, so, proc, tmp in jobs:
            try:
                _finish(src, so, proc, tmp)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its hashed library is missing, then load
    it (once per process)."""
    build_libraries([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(library_path(name))
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
