"""ctypes binding to the native image-decode runtime `native/libsift_io.so`
(counterpart of `sift_tpu/io/native.py`; host decoding, no device work).

The library is built on first use by one `make -C native` when it is
missing and a toolchain is present. Without it, `get_lib` and
`load_image_gray_native` return None and `NativeLoader` raises; callers
decode with PIL (`io/image.py`) instead.

`NativeLoader` wraps the C++ worker-pool prefetcher: it decodes a file
list ahead of consumption on host threads, outside the interpreter lock.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Iterator, List, Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libsift_io.so")

_lib = None
_lib_lock = threading.Lock()


def _build() -> bool:
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    return os.path.exists(_SO_PATH)


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_SO_PATH) and not _build():
            return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError:
            return None
        lib.sift_load_gray.restype = ctypes.POINTER(ctypes.c_float)
        lib.sift_load_gray.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.sift_free.restype = None
        lib.sift_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        lib.sift_loader_open.restype = ctypes.c_void_p
        lib.sift_loader_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        lib.sift_loader_next.restype = ctypes.POINTER(ctypes.c_float)
        lib.sift_loader_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.sift_loader_close.restype = None
        lib.sift_loader_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def _take(lib, ptr, w: int, h: int) -> np.ndarray:
    """Copy a (h, w) float32 frame out of native memory and free it."""
    arr = np.ctypeslib.as_array(ptr, shape=(h, w)).copy()
    lib.sift_free(ptr)
    return arr


def load_image_gray_native(path: str) -> Optional[np.ndarray]:
    """Decode an image to (H, W) float32 gray in [0, 255] natively; None if
    the library or the codec is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    ptr = lib.sift_load_gray(path.encode(), ctypes.byref(w), ctypes.byref(h))
    if not ptr:
        return None
    return _take(lib, ptr, w.value, h.value)


class NativeLoader:
    """Ordered, prefetching frame iterator over a list of image files."""

    def __init__(self, paths: List[str], threads: int = 4,
                 queue_cap: int = 8):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native IO library unavailable")
        self._lib = lib
        self._paths = [p.encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._handle = lib.sift_loader_open(arr, len(self._paths),
                                            threads, queue_cap)
        self._n = len(paths)
        self._i = 0

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        if self._handle is None or self._i >= self._n:
            self.close()
            raise StopIteration
        w = ctypes.c_int()
        h = ctypes.c_int()
        ptr = self._lib.sift_loader_next(self._handle, ctypes.byref(w),
                                         ctypes.byref(h))
        idx = self._i
        self._i += 1
        if not ptr:
            # Frames remain (checked above), so a null is the decode-error
            # sentinel: raise rather than end the sequence early.
            self.close()
            raise IOError(
                f"native loader: decode failed for frame {idx} "
                f"({self._paths[idx].decode(errors='replace')})")
        return _take(self._lib, ptr, w.value, h.value)

    def close(self):
        if self._handle is not None:
            self._lib.sift_loader_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — a finalizer must not raise
            pass
