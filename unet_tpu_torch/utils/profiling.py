"""Tracing and profiling hooks.

Counterpart of ``unet_tpu/utils/profiling.py``:

* ``trace(logdir)``: a ``torch.profiler`` session (CPU and, where there
  is a card, CUDA activities) around a hot region; on exit it writes a
  Chrome trace (``trace_<pid>.json``, readable by Perfetto or
  chrome://tracing) into ``logdir``. A no-op when ``logdir`` is falsy.
* ``annotate(name)``: a named sub-region inside a trace
  (``torch.profiler.record_function``).
* ``StepTimer``: step wall-clock and items/s, synchronised by reading a
  scalar back from the device.
* ``nan_guard``: torch has no ``jax_debug_nans``; the train CLI's
  ``--debug-nans`` instead checks each super-batch loss with
  ``check_finite`` (a readback, so it syncs).
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """torch.profiler session around the block; writes a Chrome trace
    into ``logdir`` on exit. No-op when ``logdir`` is falsy."""
    if not logdir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / f'trace_{os.getpid()}.json'))


def annotate(name: str):
    """Named sub-region inside a trace."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Accumulates per-step wall times and derives throughput."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._t0 = None
        self.steps: List[float] = []

    def start(self) -> None:
        self._t0 = time.time()

    def stop(self, sync_value=None) -> float:
        """Stop the current step; a tensor ``sync_value`` (the step's
        loss) is read back first, which waits for the device."""
        if sync_value is not None:
            float(sync_value)
        dt = time.time() - self._t0
        self.steps.append(dt)
        return dt

    def summary(self, items_per_step: int = 1) -> Dict[str, float]:
        if not self.steps:
            return {'steps': 0, 'total_s': 0.0, 'mean_ms': 0.0,
                    'items_per_sec': 0.0}
        total = sum(self.steps)
        return {
            'steps': len(self.steps),
            'total_s': total,
            'mean_ms': 1e3 * total / len(self.steps),
            'items_per_sec': items_per_step * len(self.steps) / total,
        }


class nan_guard:
    """Fail on the first non-finite value handed to ``check_finite``.
    Disabled, ``check_finite`` costs nothing; enabled, it reads the value
    back, which syncs with the device."""

    def __init__(self, enable: bool = True):
        self.enabled = bool(enable)

    def check_finite(self, value: torch.Tensor, what: str) -> None:
        if self.enabled and not bool(torch.isfinite(value).all()):
            raise FloatingPointError(f'non-finite {what}')
