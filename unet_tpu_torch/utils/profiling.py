"""Tracing and profiling hooks.

Counterpart of ``unet_tpu/utils/profiling.py``:

* ``annotate(name, device=None)``: the program's span. With the recorder
  off it returns one shared no-op context manager. Between
  ``spans.start()`` and ``spans.stop()`` it records a ``Span``: its
  name, its start and end from ``time.time_ns()`` (the clock of
  ``torch.profiler``'s Chrome trace: ``ts`` in microseconds plus the
  file's ``baseTimeNanoseconds``), its thread and the enclosing span of
  that thread; with a CUDA ``device`` also the device seconds between
  two CUDA events recorded on the device's current stream at entry and
  exit, resolved in ``stop()``, so nothing synchronises while the
  recorder is on. A span opens no ``record_function``: a region entered
  in one profiler session and left in the next, as when a session stops
  and another starts inside a train step, crashes torch when the second
  is exported.
* The program's span names (``TRAIN_FETCH`` ...), in one place for the
  program and whatever reads the spans.
* ``trace(logdir)``: a ``torch.profiler`` session (CPU and, where there
  is a card, CUDA activities) around a hot region, with the span
  recorder on; on exit it writes a Chrome trace (``trace_<pid>.json``,
  readable by Perfetto or chrome://tracing) into ``logdir`` holding the
  session's ops and kernels and the program's spans (``cat``
  ``program_span``, on their thread's row, device seconds in ``args``).
  A no-op when ``logdir`` is falsy.
* ``nan_guard``: torch has no ``jax_debug_nans``; the train CLI's
  ``--debug-nans`` instead checks each super-batch loss with
  ``check_finite`` (a readback, so it syncs).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import threading
import time
from pathlib import Path
from typing import List, Optional

import torch

# the train loop's spans, outermost first
TRAIN_FETCH = 'train.fetch'      # the loop thread getting a super-batch
LOADER_WAIT = 'loader.wait'      # BatchLoader: a batch gathered and stacked
H2D_STAGE = 'h2d.stage'          # prefetch_to_device: pinned, copies queued
TRAIN_AUGMENT = 'train.augment'  # the super-batch augmented or normalised
TRAIN_STEP = 'train.step'        # the optimizer step dispatched
STEP_UPDATE = 'step.update'      # TrainStep after the grads: clip, AdamW, EMA
# TransUNet's forward (models/transunet.py), inside a microbatch's step
MODEL_CNN = 'model.cnn'                  # ResNet root, stages, embedding
MODEL_TRANSFORMER = 'model.transformer'  # the blocks and encoder_norm
MODEL_DECODER = 'model.decoder'          # DecoderCup and the head

SPAN_CATEGORY = 'program_span'   # the spans' ``cat`` in a Chrome trace


@dataclasses.dataclass
class Span:
    """One recorded span; times in ns on ``time.time_ns()``'s clock."""
    id: int
    name: str
    start_ns: int
    end_ns: int
    thread: int                     # native thread id: the trace's ``tid``
    parent: Optional[int]           # the enclosing span of the same thread
    device_s: Optional[float] = None


class SpanRecorder:
    """Collects the spans that ``annotate`` opens between ``start`` and
    ``stop``. One per process (``spans``), as a profiler session is: the
    spans come from wherever the program does the work."""

    def __init__(self):
        self._on: Optional[_Recording] = None
        self._local = threading.local()
        self._ids = itertools.count()

    def start(self) -> None:
        if self._on is not None:
            raise RuntimeError('the span recorder is already on')
        self._on = _Recording()

    def stop(self) -> List[Span]:
        """Turn the recorder off; returns the spans that closed while it
        was on, by start time. A span still open is dropped."""
        rec, self._on = self._on, None
        if rec is None:
            raise RuntimeError('the span recorder is off')
        for span, begin, end in rec.events:
            end.synchronize()
            span.device_s = begin.elapsed_time(end) / 1e3
        return sorted(rec.spans, key=lambda s: s.start_ns)

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, 'stack', None)
        if stack is None:
            stack = self._local.stack = []
        return stack


class _Recording:
    __slots__ = ('spans', 'events')

    def __init__(self):
        self.spans: List[Span] = []
        self.events: List[tuple] = []   # (span, entry event, exit event)


spans = SpanRecorder()
_OFF = contextlib.nullcontext()


def annotate(name: str, device: Optional[torch.device] = None):
    """The span ``name`` around a block of the program; ``device`` (a
    ``torch.device``) where the block's device time is wanted."""
    if spans._on is None:
        return _OFF
    return _SpanContext(name, device, spans._on)


class _SpanContext:
    __slots__ = ('name', 'device', 'rec', 'span', 'events')

    def __init__(self, name: str, device: Optional[torch.device],
                 rec: _Recording):
        self.name, self.device, self.rec = name, device, rec
        self.span = self.events = None

    def __enter__(self) -> Span:
        # the recorder's own work stays outside the span's interval
        if self.device is not None and self.device.type == 'cuda':
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(torch.cuda.current_stream(self.device))
        stack = spans._stack()
        self.span = Span(next(spans._ids), self.name, time.time_ns(), 0,
                         threading.get_native_id(),
                         stack[-1].id if stack else None)
        stack.append(self.span)
        return self.span

    def __exit__(self, *exc) -> bool:
        span = self.span
        span.end_ns = time.time_ns()
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
        spans._stack().pop()
        if spans._on is self.rec:
            self.rec.spans.append(span)
            if self.events is not None:
                self.rec.events.append((span, *self.events))
        return False


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """torch.profiler session around the block, with the span recorder
    on; writes a Chrome trace holding both into ``logdir`` on exit.
    No-op when ``logdir`` is falsy."""
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
        spans.start()
        try:
            yield prof
        finally:
            recorded = spans.stop()
    path = out / f'trace_{os.getpid()}.json'
    prof.export_chrome_trace(str(path))
    add_spans_to_trace(path, recorded)


def add_spans_to_trace(path: Path, recorded: List[Span]) -> None:
    """Append ``recorded`` to the Chrome trace at ``path`` as complete
    (``X``) events of category ``SPAN_CATEGORY`` on their thread's row,
    timed from the file's ``baseTimeNanoseconds``."""
    data = json.loads(Path(path).read_text())
    base = int(data.get('baseTimeNanoseconds', 0))
    pid = os.getpid()
    for s in recorded:
        args = {'id': s.id, 'parent': s.parent}
        if s.device_s is not None:
            args['device_s'] = s.device_s
        data['traceEvents'].append({
            'ph': 'X', 'cat': SPAN_CATEGORY, 'name': s.name, 'pid': pid,
            'tid': s.thread, 'ts': (s.start_ns - base) / 1e3,
            'dur': (s.end_ns - s.start_ns) / 1e3, 'args': args})
    Path(path).write_text(json.dumps(data))


class nan_guard:
    """Fail on the first non-finite value handed to ``check_finite``.
    Disabled, ``check_finite`` costs nothing; enabled, it reads the value
    back, which syncs with the device."""

    def __init__(self, enable: bool = True):
        self.enabled = bool(enable)

    def check_finite(self, value: torch.Tensor, what: str) -> None:
        if self.enabled and not bool(torch.isfinite(value).all()):
            raise FloatingPointError(f'non-finite {what}')
