"""Memory-mapped slice cache, and the ctypes binding to the native
decoder ``csrc/libslicecache.so``.

Counterpart of ``unet_tpu/data/cache.py``:

* ``build_cache`` decodes and resizes every slice of
  ``root/{images,labels}/*.png`` once into one uint8 blob, natively
  (``build_slice_cache``, multithreaded C++/libpng) where the library
  loads and with PIL otherwise; both builders write the same bytes as
  the JAX package's. Blob layout::

      'USC1' | int32 n | int32 img_size | n*S*S image bytes | n*S*S masks

  with a ``<cache>.json`` sidecar listing the slice filenames;
* ``CachedSliceDataset`` memory-maps the blob: ``load_raw`` is a
  zero-copy view, and the split is ``volume_split``'s;
* ``native_decode_mem`` decodes the server's request bodies and
  ``native_decode_batch`` the predict CLI's files.

The library is the repository's own C++/libpng code, shared by both
packages and built with ``make -C csrc`` at first use.
"""

from __future__ import annotations

import ctypes
import json
import struct
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from unet_tpu_torch.data.dataset import _Slices, volume_split

_MAGIC = b'USC1'
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
            lib.build_slice_cache.restype = ctypes.c_int
            lib.build_slice_cache.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.c_char_p, ctypes.c_int]
            lib.slice_cache_last_error.restype = ctypes.c_char_p
            lib.slice_cache_last_error.argtypes = []
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


def _build_native(image_paths: List[str], label_paths: List[str],
                  img_size: int, out_path: str, num_threads: int = 0
                  ) -> bool:
    """Build the blob with the native builder; False when the library is
    unavailable, raises when it fails."""
    lib = _native_lib()
    if lib is None:
        return False
    n = len(image_paths)
    arr = ctypes.c_char_p * n
    rc = lib.build_slice_cache(arr(*[p.encode() for p in image_paths]),
                               arr(*[p.encode() for p in label_paths]), n,
                               img_size, out_path.encode(), num_threads)
    if rc != 0:
        raise RuntimeError('native cache build failed: '
                           f'{lib.slice_cache_last_error().decode()}')
    return True


def _build_python(image_paths: List[str], label_paths: List[str],
                  img_size: int, out_path: str) -> None:
    """The PIL builder: images BILINEAR and masks NEAREST where the size
    differs, masks binarized at > 127."""
    from PIL import Image
    plane = img_size * img_size
    with open(out_path, 'wb') as f:
        f.write(_MAGIC)
        f.write(struct.pack('<ii', len(image_paths), img_size))
        for paths, is_mask in ((image_paths, False), (label_paths, True)):
            for p in paths:
                im = Image.open(p).convert('L')
                if im.size != (img_size, img_size):
                    im = im.resize((img_size, img_size),
                                   Image.NEAREST if is_mask
                                   else Image.BILINEAR)
                a = np.asarray(im, np.uint8)
                if is_mask:
                    a = (a > 127).astype(np.uint8)
                if a.size != plane:
                    raise ValueError(f'{p}: decoded to {a.shape}')
                f.write(a.tobytes())


def build_cache(dataset_root: str, out_path: str, img_size: int = 512,
                prefer_native: bool = True, num_threads: int = 0) -> str:
    """Build the cache blob and its ``.json`` sidecar for
    ``root/{images,labels}/*.png``; returns ``out_path``. The sidecar's
    ``native`` says which builder wrote the blob."""
    root = Path(dataset_root)
    names = sorted(p.name for p in (root / 'images').glob('*.png'))
    if not names:
        raise ValueError(f'no PNGs under {root}/images')
    image_paths = [str(root / 'images' / n) for n in names]
    label_paths = [str(root / 'labels' / n) for n in names]
    out_path = str(out_path)
    native = prefer_native and _build_native(image_paths, label_paths,
                                             img_size, out_path, num_threads)
    if not native:
        _build_python(image_paths, label_paths, img_size, out_path)
    Path(out_path + '.json').write_text(json.dumps(
        {'files': names, 'img_size': img_size, 'native': native}))
    return out_path


class CachedSliceDataset(_Slices):
    """Zero-decode dataset over a cache blob, with ``SliceDataset``'s
    interface and split: ``load_raw`` gives (image, mask) uint8 (S, S)
    views of the memory map, ``load`` float32 [0, 1] and int32."""

    def __init__(self, cache_path: str, split: str = 'train',
                 val_ratio: float = 0.2, test_ratio: float = 0.0,
                 seed: int = 42):
        cache_path = str(cache_path)
        all_files: List[str] = json.loads(
            Path(cache_path + '.json').read_text())['files']
        with open(cache_path, 'rb') as f:
            magic = f.read(4)
            if magic != _MAGIC:
                raise ValueError(f'bad cache magic {magic!r}')
            n, img_size = struct.unpack('<ii', f.read(8))
        if n != len(all_files):
            raise ValueError('cache/sidecar length mismatch')
        self.img_size = img_size
        shape = (n, img_size, img_size)
        self._images = np.memmap(cache_path, np.uint8, 'r', offset=12,
                                 shape=shape)
        self._masks = np.memmap(cache_path, np.uint8, 'r',
                                offset=12 + n * img_size * img_size,
                                shape=shape)
        self.files = volume_split(all_files, split, val_ratio, test_ratio,
                                  seed)
        self._index = {name: i for i, name in enumerate(all_files)}
        print(f'CachedSliceDataset [{split}]: {len(self.files)} samples '
              f'(of {n} cached @ {img_size})')

    def load_raw(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        i = self._index[self.files[idx]]
        return self._images[i], self._masks[i]

    def load(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        img, msk = self.load_raw(idx)
        return (np.asarray(img, np.float32) / 255.0,
                np.asarray(msk, np.int32))
