"""Host-side JPEG decode for the file datasets (counterpart of
facialmmt_tpu/native/__init__.py).

`faceloader.cpp`, a copy of the JAX package's source, decodes and resizes a
batch of JPEGs with libjpeg on a std::thread pool.  It is built with g++ at
first use into the package's git-ignored `_build/` and bound with ctypes.
Where g++ or libjpeg is missing, `decode_images` decodes with cv2 one image
at a time, as the JAX package's datasets do; where neither exists it raises
and names both.  Nothing is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "faceloader.cpp")
_LIB = os.path.join(os.path.dirname(_HERE), "_build", "libfaceloader.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _build() -> Optional[str]:
    """Compile faceloader.cpp; None on success, else the compiler's reason."""
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
           _SRC, "-o", tmp, "-ljpeg", "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{type(e).__name__}: {e}"
    if proc.returncode != 0:
        return proc.stderr.strip()[-400:] or f"g++ exit {proc.returncode}"
    os.replace(tmp, _LIB)
    return None


def load_library() -> Optional[ctypes.CDLL]:
    """Build (once) and load the native decoder; None when it cannot be built
    or loaded here (the reason is kept for decoder_name's error)."""
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        if not os.path.exists(_LIB) or (
                os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            _build_error = _build()
            if _build_error is not None:
                return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError as e:
            _build_error = str(e)
            return None
        lib.decode_resize_batch.restype = ctypes.c_int
        lib.decode_resize_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int]
        _lib = lib
        return _lib


def decode_resize_batch(paths: List[Optional[str]],
                        target: int) -> Optional[np.ndarray]:
    """Decode JPEGs into a (N, target, target, 3) BGR uint8 array on the
    native thread pool (one thread per hardware thread); None when the
    native library is unavailable.  A path that fails to decode (or None)
    leaves its slot zeroed."""
    lib = load_library()
    if lib is None:
        return None
    n = len(paths)
    out = np.zeros((n, target, target, 3), np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() if p else None for p in paths])
    lib.decode_resize_batch(
        arr, n, target, out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        0)
    return out


def decoder_name() -> str:
    """'native' or 'cv2': what `decode_images` uses on this machine."""
    if load_library() is not None:
        return "native"
    try:
        import cv2  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            "no JPEG decoder: the native faceloader could not be built "
            f"({_build_error}) and cv2 cannot be imported ({e}); install "
            "g++ with libjpeg's headers, or OpenCV's Python package") from e
    return "cv2"


def decode_images(paths: List[str], target: int, upscale_interp: str = "cubic"
                  ) -> np.ndarray:
    """(N, target, target, 3) BGR uint8 (cv2.imread order: the released
    checkpoints were trained on BGR-as-RGB).  Native thread pool first, per
    image cv2 otherwise (INTER_AREA when shrinking; when enlarging
    INTER_CUBIC, or INTER_AREA with upscale_interp='area' as the Aff-Wild2
    loader has it).  An unreadable file leaves its slot zeroed in both."""
    if decoder_name() == "native":
        return decode_resize_batch(paths, target)
    import cv2

    out = np.zeros((len(paths), target, target, 3), np.uint8)
    for i, p in enumerate(paths):
        im = cv2.imread(p)
        if im is None:
            continue
        if im.shape[:2] != (target, target):
            interp = (cv2.INTER_AREA if im.shape[0] > target
                      or upscale_interp == "area" else cv2.INTER_CUBIC)
            im = cv2.resize(im, (target, target), interpolation=interp)
        out[i] = im
    return out
