"""Native (C++) runtime components, consumed through ctypes.

The compute path is JAX/XLA on the GPU; the host runtime around it is
native where the reference's is: `loader.cpp` is a threaded PNG
decoder/prefetcher (the reference decodes with cv::imread inline on the
tracking thread, stereo_kitti.cc:108). Built on demand with g++ (-lpng) and
cached next to the source; falls back cleanly when no toolchain exists.
"""
from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).parent / "loader.cpp"
_LIB = Path(__file__).parent / "libloader.so"
_lib = None
_tried = False


def _build() -> bool:
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", str(_SRC),
             "-lpng", "-o", str(_LIB)],
            check=True, capture_output=True, timeout=120)
        return True
    except Exception:
        return False


def get_lib():
    """The loaded C library, or None when unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(str(_LIB))
    except OSError:
        return None
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_create.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                  ctypes.c_size_t, ctypes.c_size_t,
                                  ctypes.c_size_t]
    lib.loader_get.restype = ctypes.c_int
    lib.loader_get.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                               ctypes.POINTER(ctypes.c_uint8),
                               ctypes.POINTER(ctypes.c_uint32),
                               ctypes.POINTER(ctypes.c_uint32),
                               ctypes.c_size_t]
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    lib.loader_probe_size.restype = ctypes.c_int
    lib.loader_probe_size.argtypes = [ctypes.c_char_p,
                                      ctypes.POINTER(ctypes.c_uint32),
                                      ctypes.POINTER(ctypes.c_uint32)]
    _lib = lib
    return _lib


class NativeImageLoader:
    """Threaded-prefetch grayscale PNG reader. frame(i) -> (H, W) uint8."""

    def __init__(self, paths, window: int = 8, n_threads: int = 2):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native loader unavailable (no g++/libpng)")
        self._lib = lib
        self.paths = [str(p) for p in paths]
        arr = (ctypes.c_char_p * len(self.paths))(
            *[p.encode() for p in self.paths])
        self._handle = lib.loader_create(arr, len(self.paths), window,
                                         n_threads)
        w = ctypes.c_uint32()
        h = ctypes.c_uint32()
        if lib.loader_probe_size(self.paths[0].encode(),
                                 ctypes.byref(w), ctypes.byref(h)) != 1:
            raise RuntimeError(f"cannot read {self.paths[0]}")
        self.w, self.h = int(w.value), int(h.value)
        self._buf = np.empty(self.h * self.w, np.uint8)

    def __len__(self):
        return len(self.paths)

    def frame(self, i: int) -> np.ndarray:
        w = ctypes.c_uint32()
        h = ctypes.c_uint32()
        rc = self._lib.loader_get(
            self._handle, i,
            self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.byref(w), ctypes.byref(h), self._buf.size)
        if rc != 1:
            raise RuntimeError(f"decode failed for {self.paths[i]} (rc={rc})")
        return self._buf[: int(w.value) * int(h.value)].reshape(
            int(h.value), int(w.value)).copy()

    def close(self):
        if self._handle:
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
