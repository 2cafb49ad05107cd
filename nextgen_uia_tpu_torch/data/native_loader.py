"""ctypes binding for the native C++ batch image loader (native/loader.cc).

Builds on demand (``make -C native``) and falls back to PIL when the
toolchain or image libraries are unavailable, so the framework never hard-
depends on the native path. The loader decodes PNG/JPEG, converts to
grayscale with PIL's "L" weights, bilinear-resizes, and fills a caller-owned
uint8 batch buffer from a C++ thread pool — the host-side hot path when
feeding the device. (The port's own copy of
nextgen_uia_tpu/data/native_loader.py, binding the same library.)
"""

from __future__ import annotations

import ctypes
import logging
import os
import pathlib
import subprocess

import numpy as np

_NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libuia_loader.so"
_lib = None
_tried = False


def _build() -> bool:
    try:
        subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                       capture_output=True, timeout=120)
        return _LIB_PATH.exists()
    except Exception as e:
        logging.info(f"native loader build skipped: {e}")
        return False


def get_lib():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _LIB_PATH.exists() and not _build():
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
        lib.decode_batch.restype = ctypes.c_int
        lib.decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int,
        ]
        _lib = lib
    except OSError as e:
        logging.info(f"native loader unavailable: {e}")
    return _lib


def available() -> bool:
    return get_lib() is not None


def decode_batch(paths, img_size: int, *, gray: bool = True,
                 num_threads: int = 0):
    """Decode+resize a list of image paths into [N, S, S, C] uint8.

    Returns (batch, status) where status[i] == 1 for successful decodes.
    Raises RuntimeError when the native library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native loader not available")
    n = len(paths)
    c = 1 if gray else 3
    out = np.zeros((n, img_size, img_size, c), dtype=np.uint8)
    status = np.zeros((n,), dtype=np.uint8)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(str(p)) for p in paths])
    lib.decode_batch(
        arr, n, img_size, 1 if gray else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        num_threads)
    return out, status
