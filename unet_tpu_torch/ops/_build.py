"""Build, load and launch the port's hand-written CUDA kernels.

Each ``unet_tpu_torch/csrc/<name>.cu`` has a plain C interface and is
compiled by ``nvcc`` for Hopper (``sm_90a``) into
``unet_tpu_torch/build/lib<name>.so``, which is loaded with ctypes. The
build runs at first use, or when the source or any shared header
(``csrc/*.cuh``, such as ``hopper.cuh``) is newer than the library;
``build_all()`` starts one ``nvcc`` per source at once. Delete
``unet_tpu_torch/build/`` to force a rebuild. Nothing here runs at
import time, so the CPU-only tests import this module freely.

An op module declares its library once as ``Kernels`` (its C functions'
signatures and the kernels each launches) and calls the functions on
it: a launch that returns nonzero raises with the library's message,
one that returns zero adds its kernels to ``launches``, the one tally of
the process. ``check_device`` is the check every launch makes first.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence, Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / 'csrc'
BUILD = _PKG / 'build'
SOURCES = ('attention_gate', 'warp', 'conv3x3', 'batch_norm', 'group_norm',
           'resize')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

# Kernel launches in this process by library name, and the fused
# attention's calls (``ops/attention.py``) under 'attention'. Read a
# difference, or set an entry to 0; never rebind the dict, which the
# bound launch functions hold.
launches: Dict[str, int] = dict.fromkeys((*SOURCES, 'attention'), 0)


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, then PATH, then
    /usr/local/cuda/bin/nvcc."""
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    candidates = [os.path.join(home, 'bin', 'nvcc')] if home else []
    candidates += [shutil.which('nvcc') or '', '/usr/local/cuda/bin/nvcc']
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError('nvcc not found (set CUDA_HOME); the CUDA kernels '
                       'of unet_tpu_torch are built on the machine with '
                       'the GPU')


def library_path(name: str) -> Path:
    return BUILD / f'lib{name}.so'


def is_stale(name: str) -> bool:
    """True when ``lib<name>.so`` is missing or older than
    ``csrc/<name>.cu`` or any header ``csrc/*.cuh`` (every source may
    include every header)."""
    so = library_path(name)
    if not so.exists():
        return True
    built = so.stat().st_mtime
    deps = [CSRC / f'{name}.cu', *CSRC.glob('*.cuh')]
    return any(d.stat().st_mtime > built for d in deps)


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists
    (``is_stale``). The compiler's output (ptxas register/spill report
    included) is kept in ``build/<name>.log``. Raises with that output
    on failure."""
    src = CSRC / f'{name}.cu'
    so = library_path(name)
    if not is_stale(name):
        return so
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f'.{os.getpid()}.{threading.get_ident()}.tmp')
    cmd = [nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (BUILD / f'{name}.log').write_text(
        ' '.join(cmd) + '\n' + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'nvcc failed for {src}:\n{proc.stdout}'
                           f'{proc.stderr}')
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return so


def build_all() -> Dict[str, Path]:
    """Build every kernel source concurrently (one nvcc each)."""
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        return dict(zip(SOURCES, pool.map(build, SOURCES)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, building it on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        return lib


class Kernels:
    """The C functions of the library ``name`` (one of ``SOURCES``, the
    tally's keys), bound at first use.

    ``functions`` maps each function's name to ``(argtypes, kernels)``.
    A function of ``kernels`` > 0 launches that many kernels and returns
    the library's error code: bound, a nonzero code raises
    ``RuntimeError('<name> kernel launch failed: ' + <error>(code))``,
    and zero adds ``kernels`` to ``launches[name]``. A function of
    ``kernels`` 0 is a query of the library's limits: it takes no
    argument and is read once, at binding, into the attribute of its
    name. ``error`` names the library's ``const char *(int)`` message
    function."""

    def __init__(self, name: str, error: str,
                 functions: Dict[str, Tuple[Sequence, int]]):
        self.name, self._error, self._functions = name, error, functions

    def __getattr__(self, attr):
        # only before binding: bind() sets every function's attribute
        if attr.startswith('_'):
            raise AttributeError(attr)
        self.bind(load(self.name))
        return object.__getattribute__(self, attr)

    def bind(self, lib) -> None:
        """Bind the functions of ``lib`` (a ``ctypes.CDLL``, or anything
        with the same attributes), replacing those bound before; the
        library itself becomes ``self.lib``."""
        error = getattr(lib, self._error)
        error.argtypes, error.restype = [ctypes.c_int], ctypes.c_char_p
        for fn_name, (argtypes, kernels) in self._functions.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = list(argtypes)
            setattr(self, fn_name,
                    self._launcher(fn, kernels, error) if kernels else fn())
        self.lib = lib

    def _launcher(self, fn, kernels: int, error):
        name, tally = self.name, launches

        def launch(*args) -> None:
            err = fn(*args)
            if err:
                raise RuntimeError(f'{name} kernel launch failed: '
                                   + error(err).decode())
            tally[name] += kernels
        return launch


def check_device(op: str, t: torch.Tensor, name: str = 'x') -> None:
    """Raise unless ``t`` is a CUDA tensor on the current device, whose
    stream a launch takes; ``op`` starts the message."""
    if t.device.type != 'cuda':
        raise ValueError(f'{op}: no kernel for {t.device}')
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f'{op}: {name} is on {t.device}, the current '
                         f'device is {torch.cuda.current_device()}')
