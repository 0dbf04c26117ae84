"""What every cell shares: finding files by name, seeds, the run's
context, the device record and the check that JAX stayed out."""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that may not be loaded by a run: JAX, its
# libraries, and the JAX package this port was made from (compared whole:
# the port's own name begins with it)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'unet_tpu')


class WindowClosed(Exception):
    """Raised inside the program's loop to end it once the measured
    window (or the set-up a reading needs) is over."""


def load_named(kind: str, name: str, root: Path = HERE) -> Dict[str, Any]:
    """``<root>/<kind>/<name>.json``: a workload, config or traffic."""
    path = root / kind / f'{name}.json'
    if not path.is_file():
        raise FileNotFoundError(f'no {kind[:-1]} named {name!r} ({path})')
    return json.loads(path.read_text())


def load_reference(config: Dict[str, Any], root: Path = HERE) -> ModuleType:
    """The configuration's plain reference, ``<root>/reference/<name>.py``
    with the name from its top-level ``"reference"`` (``model`` where it
    has none), loaded by path so a root of a test's own holds its own.
    ``reference/__init__.py`` lists what the module provides."""
    name = config.get('reference', 'model')
    if not re.fullmatch(r'[A-Za-z_][A-Za-z0-9_]*', name):
        raise ValueError(f'reference {name!r} is not a module name')
    path = root / 'reference' / f'{name}.py'
    if not path.is_file():
        raise FileNotFoundError(f'no reference named {name!r} ({path})')
    spec = importlib.util.spec_from_file_location(
        f'bench_h100_reference_{name}', path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def derive_seed(seed: int, label: str) -> int:
    """A 31-bit seed for one use of the run's seed (any whole number,
    negative or beyond 64 bits included)."""
    digest = hashlib.sha256(f'{seed}:{label}'.encode()).digest()
    return int.from_bytes(digest[:4], 'little') & 0x7FFFFFFF


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that a run may not load."""
    tops = {name.split('.', 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def set_cache_dirs(root: Path = ROOT) -> None:
    """Kernel caches at fixed paths inside the checkout, so only the
    first run of a checkout builds. The port's own CUDA kernels build
    into ``unet_tpu_torch/build/`` beside its sources."""
    cache = root / '.bench_cache'
    os.environ['TRITON_CACHE_DIR'] = str(cache / 'triton')
    os.environ['TORCH_EXTENSIONS_DIR'] = str(cache / 'torch_extensions')


def card_line() -> str:
    """The first card's name and power limit, from nvidia-smi."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f'nvidia-smi failed: {e}'
    return out[0].strip() if out else 'nvidia-smi printed no card'


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Context:
    """One run of one cell."""
    workload: str
    config: Dict[str, Any]
    arch: ModuleType        # the configuration's reference module
    traffic: Dict[str, Any]
    workload_file: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    chips: int
    device: str          # 'cuda' on the card; 'cpu' only in the tests
    tmp: Path            # this run's scratch directory
    t_start: float       # perf_counter at process start

    @property
    def limits(self) -> Dict[str, float]:
        return self.workload_file.get('limits', {})


@dataclasses.dataclass
class Outcome:
    """What a driver hands back to ``run.py``."""
    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    compared: Dict[str, Dict[str, float]]   # name -> {value, limit}
    memory_peak_bytes: int
    device_kind: str
    device_count: int
    layer: Dict[str, Any] = dataclasses.field(default_factory=dict)
    trace: Optional[Any] = None             # trace.TraceSummary

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(
            c['value'] <= c['limit'] for c in self.compared.values())


def pick_compared(numbers: Dict[str, float], limits: Dict[str, float]
                  ) -> Dict[str, Dict[str, float]]:
    """The numbers that have a limit, each beside it; the others are
    printed for the record and decide nothing."""
    for k, v in numbers.items():
        if k not in limits:
            log(f'reading {k}: {v!r} (not compared)')
    return {k: {'value': float(numbers[k]), 'limit': float(limits[k])}
            for k in limits}


def make_context(workload: str, seed: int, seconds: float,
                 trace: bool = False, device: str = 'cuda',
                 root: Path = HERE, t_start: Optional[float] = None
                 ) -> Context:
    """The context of one run of ``workload`` (files under ``root``), with
    a fresh scratch directory under TMPDIR."""
    cell = load_named('workloads', workload, root)
    config = load_named('configs', cell['config'], root)
    return Context(workload=workload, config=config,
                   arch=load_reference(config, root),
                   traffic=load_named('traffic', cell['traffic'], root),
                   workload_file=cell, seed=seed, seconds=seconds,
                   trace=trace, chips=cell['chips'], device=device,
                   tmp=Path(tempfile.mkdtemp(prefix='bench_h100_')),
                   t_start=time.monotonic() if t_start is None else t_start)
