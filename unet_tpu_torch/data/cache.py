"""ctypes binding to the native decoder ``csrc/libslicecache.so``.

Counterpart of the decode half of ``unet_tpu/data/cache.py`` (the slice
cache itself joins with the data-pipeline slice): ``native_decode_mem``
for the server's request bodies and ``native_decode_batch`` for the
predict CLI's files. The library is the repository's own C++/libpng
code, shared by both packages and built with ``make -C csrc`` at first
use.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_CSRC = Path(__file__).resolve().parent.parent.parent / 'csrc'
_PNG_MAGIC = b'\x89PNG\r\n\x1a\n'

_lock = threading.Lock()
_lib_cache: list = []  # [CDLL or None] once resolved


def _native_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native decoder; None when it cannot
    be built or loaded. The handle is memoized."""
    with _lock:
        if _lib_cache:
            return _lib_cache[0]
        so = _CSRC / 'libslicecache.so'
        lib = None
        try:
            if not so.exists():
                subprocess.run(['make', '-C', str(_CSRC)], check=True,
                               capture_output=True)
            lib = ctypes.CDLL(str(so))
            if not hasattr(lib, 'decode_resize_mem'):  # stale library
                subprocess.run(['make', '-B', '-C', str(_CSRC)], check=True,
                               capture_output=True)
                lib = ctypes.CDLL(str(so))
        except (subprocess.CalledProcessError, FileNotFoundError, OSError):
            lib = None
        if lib is not None:
            lib.decode_resize_batch.restype = ctypes.c_int
            lib.decode_resize_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int]
            lib.decode_resize_mem.restype = ctypes.c_int
            lib.decode_resize_mem.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32)]
        _lib_cache.append(lib)
        return lib


def native_decode_batch(paths, img_size: int, num_threads: int = 0
                        ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Threaded native PNG decode + PIL-bit-exact bilinear resize of
    files (the predict CLI's decode stage). Returns ``(images (n, S, S)
    uint8, meta (n, 2) int32)``, where a meta row is ``[orig_w, orig_h]``
    on success, ``[-1, 0]`` for a decode failure and ``[-2, 0]`` for a
    color or 16-bit input (the caller decodes both with PIL; such rows
    carry undefined pixels). None when the library is unavailable."""
    lib = _native_lib()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, img_size, img_size), np.uint8)
    meta = np.empty((n, 2), np.int32)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    lib.decode_resize_batch(
        arr, n, img_size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), num_threads)
    return out, meta


def native_decode_mem(data: bytes, img_size: int
                      ) -> Optional[Tuple[np.ndarray, Tuple[int, int]]]:
    """Native in-memory PNG decode + PIL-bit-exact bilinear resize (one
    HTTP request body per call). Returns ``(image (S, S) uint8,
    (orig_w, orig_h))``, or None when the caller should use PIL: library
    unavailable, not a PNG, corrupt, or a color/16-bit input whose PIL
    8-bit reduction libpng does not reproduce bit-exactly."""
    if not data.startswith(_PNG_MAGIC):
        return None
    lib = _native_lib()
    if lib is None:
        return None
    out = np.empty((img_size, img_size), np.uint8)
    meta = np.empty(2, np.int32)
    ok = lib.decode_resize_mem(
        ctypes.cast(ctypes.c_char_p(data), ctypes.POINTER(ctypes.c_uint8)),
        len(data), img_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if not ok:
        return None
    return out, (int(meta[0]), int(meta[1]))
