"""ctypes binding of the port's native JPEG pipeline (``jpeg_loader.cpp``),
a copy of the JAX package's ``native/loader.py``.

One C++ shared object decodes JPEGs with libjpeg (DCT-domain scaling),
resizes them with PIL's antialiased bilinear filter and fans a batch out
over ``std::thread`` workers inside the process, with the GIL released
for the whole batch.

The library is compiled at first use with the system toolchain
(``g++ -O3 -std=c++17 -shared -fPIC ... -ljpeg -pthread``) into the
package's ``_build/`` directory (listed in ``.gitignore``), named
``libicl_port_<hash of the source>.so``, so it never shares a file with
the JAX package's build. When ``g++`` or libjpeg is missing,
:func:`available` is False, :func:`unavailable_reason` says why, and the
dataset (``data/coco.py``) keeps PIL. This is host decoding: no device
kernel is involved.

Three transforms: the eval transform (resize + center crop), the train
transform (a crop box drawn in Python, resize, flip) and the decode-only
square canvas of the device-resident resize (:func:`decode_square_batch`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "jpeg_loader.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")

_lock = threading.Lock()
_lib = None
_tried = False
_reason = ""


def library_path() -> str:
    """Where the build of the current ``jpeg_loader.cpp`` goes."""
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libicl_port_{tag}.so")


def _compile(so: str) -> bool:
    global _reason
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = so + f".tmp{os.getpid()}"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", _SRC,
           "-o", tmp, "-ljpeg", "-pthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=120)
    except subprocess.CalledProcessError as e:
        _reason = f"g++ failed: {e.stderr.strip()[-400:]}"
        return False
    except (OSError, subprocess.SubprocessError) as e:
        _reason = f"g++ could not run: {e}"
        return False
    os.replace(tmp, so)
    return True


def _build() -> Optional[ctypes.CDLL]:
    global _reason
    so = library_path()
    if not os.path.exists(so) and not _compile(so):
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        # a library built on another machine (another libjpeg): once more
        # from the source, here
        if not _compile(so):
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:
            _reason = f"loading {so} failed: {e}"
            return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.icl_version.restype = ctypes.c_int
    lib.icl_probe.argtypes = [u8p, ctypes.c_size_t,
                              ctypes.POINTER(ctypes.c_int),
                              ctypes.POINTER(ctypes.c_int)]
    lib.icl_probe.restype = ctypes.c_int
    lib.icl_eval_batch.argtypes = [
        ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_size_t), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, u8p, ctypes.POINTER(ctypes.c_int),
        ctypes.c_int]
    lib.icl_train_batch.argtypes = [
        ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_size_t), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, u8p, ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.icl_square_batch.argtypes = [
        ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_size_t), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, u8p, ctypes.POINTER(ctypes.c_int),
        ctypes.c_int]
    return lib


def _get() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is None and not _tried:
        with _lock:
            if _lib is None and not _tried:
                _lib = _build()
                _tried = True
    return _lib


def available() -> bool:
    """Whether the library built (at the first call) and loaded."""
    return _get() is not None


def unavailable_reason() -> str:
    """Why :func:`available` is False (the compiler's or loader's
    message); empty when it is True."""
    _get()
    return _reason


def _ptrs(bufs: Sequence[bytes]):
    n = len(bufs)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    arr = (u8p * n)()
    lens = (ctypes.c_size_t * n)()
    for i, b in enumerate(bufs):
        arr[i] = ctypes.cast(ctypes.c_char_p(b), u8p)
        lens[i] = len(b)
    return arr, lens


def _out_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _int_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def default_threads() -> int:
    return os.cpu_count() or 1


def _lib_or_raise() -> ctypes.CDLL:
    lib = _get()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_reason}")
    return lib


def probe(buf: bytes) -> Optional[Tuple[int, int]]:
    """JPEG header decode: (width, height), or None if not a valid JPEG."""
    lib = _lib_or_raise()
    w = ctypes.c_int(0)
    h = ctypes.c_int(0)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    rc = lib.icl_probe(ctypes.cast(ctypes.c_char_p(buf), u8p), len(buf),
                       ctypes.byref(w), ctypes.byref(h))
    return (w.value, h.value) if rc == 0 else None


def decode_eval_batch(bufs: Sequence[bytes], size: int, *,
                      draft: "bool | int" = True,
                      n_threads: Optional[int] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Eval transform of a batch of JPEG byte strings: (images [n, size,
    size, 3] uint8, status [n] int32, 0 = ok). ``draft=True`` decodes at a
    reduced DCT scale that keeps the shorter side >= ``size``; an int sets
    the decode target; ``draft=False`` is the full decode that tracks PIL's
    ``center_crop_resize``."""
    lib = _lib_or_raise()
    n = len(bufs)
    # isinstance, not `is True`: np.bool_(True) would otherwise fall into
    # int(draft) == 1 and decode at a 1-pixel DCT target
    if isinstance(draft, (bool, np.bool_)):
        draft_target = size if draft else 0
    else:
        draft_target = int(draft)
    out = np.empty((n, size, size, 3), dtype=np.uint8)
    status = np.zeros(n, dtype=np.int32)
    arr, lens = _ptrs(bufs)
    lib.icl_eval_batch(arr, lens, n, size, draft_target, _out_ptr(out),
                       _int_ptr(status), n_threads or default_threads())
    return out, status


def decode_train_batch(bufs: Sequence[bytes], boxes: np.ndarray,
                       flips: np.ndarray, size: int, *,
                       n_threads: Optional[int] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Train transform: per-item crop box [n, 4] (x, y, w, h) and flip
    [n], resized to (size, size). The boxes come from the PIL path's
    seeded draw (``data/coco.draw_crop_box``)."""
    lib = _lib_or_raise()
    n = len(bufs)
    out = np.empty((n, size, size, 3), dtype=np.uint8)
    status = np.zeros(n, dtype=np.int32)
    boxes = np.ascontiguousarray(boxes, dtype=np.int32)
    flips = np.ascontiguousarray(flips, dtype=np.int32)
    arr, lens = _ptrs(bufs)
    lib.icl_train_batch(arr, lens, n, _int_ptr(boxes), _int_ptr(flips),
                        size, _out_ptr(out), _int_ptr(status),
                        n_threads or default_threads())
    return out, status


def decode_square_batch(bufs: Sequence[bytes], target: int, canvas: int, *,
                        n_threads: Optional[int] = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """The device-resize host path (``data/coco.load_image_square``'s
    native twin): a DCT-scaled decode of each image's centre square onto
    a fixed canvas. Returns (canvases [n, canvas, canvas, 3] uint8, sides
    [n] int32, negative where the decode failed)."""
    lib = _lib_or_raise()
    n = len(bufs)
    out = np.empty((n, canvas, canvas, 3), dtype=np.uint8)
    sides = np.zeros(n, dtype=np.int32)
    arr, lens = _ptrs(bufs)
    lib.icl_square_batch(arr, lens, n, target, canvas, _out_ptr(out),
                         _int_ptr(sides), n_threads or default_threads())
    return out, sides
