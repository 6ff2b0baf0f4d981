"""Native (C++) data-loader core, consumed through ctypes (port of
``densebox_tpu/native``; the port keeps its own copy of ``loader.cc``).

``load_canvas_native`` decodes, normalizes, resizes to fit and canvas-pads a
whole image batch in a GIL-free C++ thread pool, with the image semantics of
``data/pipeline.py:canvas_batch``'s Python path (equality-tested). The
library is compiled with g++ against the system OpenCV at first use, into
``densebox_tpu_torch/_build/`` under a temporary name that is then renamed.
Without g++ or the OpenCV development files ``native_available()`` is False
and ``canvas_batch(backend="auto")`` takes the Python path: a choice between
two host decoders with equal pixels.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "loader.cc")
_SO = os.path.join(os.path.dirname(_DIR), "_build", "libdensebox_loader.so")
_ABI = 1

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _compile() -> None:
    # compile to a per-process temporary name and rename: concurrent
    # processes (pytest-xdist workers) never load a half-written library
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-fPIC", "-shared", "-std=c++17",
           "-I/usr/include/opencv4", _SRC, "-o", tmp,
           "-lopencv_core", "-lopencv_imgcodecs", "-lopencv_imgproc",
           "-pthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            if (not os.path.exists(_SO)
                    or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
                _compile()
            lib = ctypes.CDLL(_SO)
            lib.densebox_loader_abi_version.restype = ctypes.c_int
            if lib.densebox_loader_abi_version() != _ABI:
                raise OSError("ABI mismatch")
            lib.densebox_load_canvas.restype = ctypes.c_int
            lib.densebox_load_canvas.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ]
            _lib = lib
        except (OSError, subprocess.CalledProcessError):
            _load_failed = True
    return _lib


def native_available() -> bool:
    """True when the compiled loader is usable on this machine (built on the
    first call)."""
    return _get_lib() is not None


def load_canvas_native(
    paths: Sequence[str], canvas_hw: Tuple[int, int],
    num_threads: int = 0, images: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, List[int]]:
    """Decode + normalize + fit + pad ``paths`` onto zeroed canvases.

    Returns ``(images (n, hc, wc, 3) f32, scales (n,) f32, status list)``
    with status 0 = ok per image. ``images``, when given, is the zeroed,
    C-contiguous float32 buffer to fill (a pinned host tensor's array).
    Raises FileNotFoundError on any failed read, as the Python path does."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native loader unavailable (no g++ or OpenCV "
                           "development files): use the python backend")
    hc, wc = canvas_hw
    n = len(paths)
    if images is None:
        images = np.zeros((n, hc, wc, 3), np.float32)
    elif (images.shape != (n, hc, wc, 3) or images.dtype != np.float32
          or not images.flags.c_contiguous):
        raise ValueError(f"images buffer {images.shape} {images.dtype} is "
                         f"not a C-contiguous float32 ({n}, {hc}, {wc}, 3)")
    scales = np.ones((n,), np.float32)
    status = np.zeros((n,), np.int32)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    failures = lib.densebox_load_canvas(
        arr, n, hc, wc,
        images.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        scales.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        num_threads)
    if failures:
        bad = [paths[i] for i in range(n) if status[i] != 0]
        raise FileNotFoundError(f"native loader failed on {bad}")
    return images, scales, list(status)
