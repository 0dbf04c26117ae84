#!/usr/bin/env python3
"""Run one training cell with the program's span recorder on, and read
the spans: five per-layer readings of the train loop, augmentation and
train step layers, and the device's idle time split by the span the
loop thread was in.

    python bench_h100/spans.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

The run is ``run.py``'s, and its result line is printed as ``run.py``
prints it; the training probe (``drivers/train.py::Probe``) is replaced
for the run by one that also turns the recorder
(``unet_tpu_torch.utils.profiling.spans``) on one step before the window
and off at its end: with ``--trace 1`` the traced window (after the gap
session, whose stop has synchronised), without it the measured window,
so the recorder's cost shows in ``train_slices_per_s``. The last line is
one JSON object ``{"spans": {...}}``: each span's count and mean host
and device milliseconds, and with ``--trace 1`` over the traced window
(the one ``mfu.train`` and ``idle_share.train`` divide by, clipped to
its bounds on the trace's clock):

* ``loader_wait.train``: % of the window the loop thread spent in
  ``train.fetch``;
* ``idle_in_fetch.train``: % of the window in which the device was idle
  while the loop thread was in ``train.fetch``;
* ``host_step.train``: % of the window the loop thread spent in
  ``train.step`` (host dispatch of forward, backward and update);
* ``augment_share.train``, ``update_share.train``: device seconds of
  ``train.augment`` and ``step.update`` entered in the window, as % of
  the window;
* ``idle_split``: the device's idle time, % of the window, by the
  top-level span the loop thread was in (fetch, augment, step, none),
  ``gap_starts``: the seconds of idle gaps of 20 us or more by the span
  the loop thread was in when each began, and ``idle_at_edges_s``: the
  idle before the window's first device op and after its last.

A reading with nothing to read (the device readings of a CPU run) is
left out.
"""

import json
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

HERE = Path(__file__).resolve().parent
if __name__ == '__main__':
    # as run.py: the benchmark as a package from the checkout's root
    sys.path[0] = str(HERE.parent)

# first: run.py's set-up clock starts when it is imported
from bench_h100 import run, tracing  # noqa: E402
from unet_tpu_torch.utils.profiling import (STEP_UPDATE,  # noqa: E402
                                            TRAIN_AUGMENT, TRAIN_FETCH,
                                            TRAIN_STEP)

Interval = Tuple[float, float]

# the loop thread's top-level spans
TOP = {'fetch': TRAIN_FETCH, 'augment': TRAIN_AUGMENT, 'step': TRAIN_STEP}


def window_of(path: Path) -> Tuple[Interval, List[Interval]]:
    """The window's bounds and the device's busy intervals, in ns on the
    clock of ``time.time_ns()``, from the Chrome trace ``summarise``
    reduces, bounded as it bounds it."""
    data = json.loads(Path(path).read_text())
    base = float(data.get('baseTimeNanoseconds', 0))
    events = [e for e in data['traceEvents'] if e.get('ph') == 'X']
    marks = {e['name']: float(e['ts']) for e in events
             if e.get('name') in (tracing.MARK + '.open',
                                  tracing.MARK + '.close')}
    if len(marks) == 2:
        w0, w1 = marks[tracing.MARK + '.open'], marks[tracing.MARK + '.close']
    else:
        session = next(e for e in events if e.get('cat') == 'Trace')
        w0 = float(session['ts'])
        w1 = w0 + float(session['dur'])
    dev = []
    for e in events:
        if e.get('cat') in tracing.DEVICE_CATS:
            s = max(float(e['ts']), w0)
            t = min(float(e['ts']) + float(e.get('dur', 0.0)), w1)
            if t > s:
                dev.append((base + 1e3 * s, base + 1e3 * t))
    return ((base + 1e3 * w0, base + 1e3 * w1), tracing._union(dev))


def _length(intervals: Sequence[Interval]) -> float:
    return sum(t - s for s, t in intervals)


def _intersect(a: Sequence[Interval], b: Sequence[Interval]
               ) -> List[Interval]:
    """Intersection of two sorted unions of intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, t = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if t > s:
            out.append((s, t))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _idle(window: Interval, busy: Sequence[Interval]) -> List[Interval]:
    out, prev = [], window[0]
    for s, t in busy:
        if s > prev:
            out.append((prev, min(s, window[1])))
        prev = max(prev, t)
    if window[1] > prev:
        out.append((prev, window[1]))
    return [(s, t) for s, t in out if t > s]


def host(recorded, name: str, window: Interval) -> List[Interval]:
    """The union of the host intervals of the spans ``name``, clipped to
    the window."""
    lo, hi = window
    return tracing._union([(max(s.start_ns, lo), min(s.end_ns, hi))
                           for s in recorded if s.name == name
                           and s.end_ns > lo and s.start_ns < hi])


def _share(seconds_ns: float, window: Interval) -> float:
    return 100.0 * seconds_ns / (window[1] - window[0])


def loader_wait(recorded, window: Interval) -> Optional[float]:
    fetch = host(recorded, TRAIN_FETCH, window)
    return _share(_length(fetch), window) if fetch else None


def host_step(recorded, window: Interval) -> Optional[float]:
    step = host(recorded, TRAIN_STEP, window)
    return _share(_length(step), window) if step else None


def idle_in_fetch(recorded, window: Interval, busy: Sequence[Interval]
                  ) -> Optional[float]:
    fetch = host(recorded, TRAIN_FETCH, window)
    if not fetch or not busy:
        return None
    return _share(_length(_intersect(fetch, _idle(window, busy))), window)


def device_share(recorded, name: str, window: Interval) -> Optional[float]:
    """Device seconds of the spans ``name`` entered inside the window:
    their work was queued after it opened and ends before it closes,
    since the window's close synchronises first."""
    secs = [s.device_s for s in recorded if s.name == name
            and window[0] <= s.start_ns < window[1]
            and s.device_s is not None]
    return _share(1e9 * sum(secs), window) if secs else None


def idle_split(recorded, window: Interval, busy: Sequence[Interval]
               ) -> Optional[Dict[str, float]]:
    if not busy:
        return None
    idle = _idle(window, busy)
    out, covered = {}, 0.0
    for key, name in TOP.items():
        part = _length(_intersect(host(recorded, name, window), idle))
        out[key] = _share(part, window)
        covered += part
    out['none'] = _share(_length(idle) - covered, window)
    return out


def gap_starts(recorded, window: Interval, busy: Sequence[Interval],
               shortest_ns: float = 1e3 * tracing.SHORT_GAP_US
               ) -> Optional[Dict[str, float]]:
    if not busy:
        return None
    tops = {key: host(recorded, name, window) for key, name in TOP.items()}
    out = {key: 0.0 for key in (*TOP, 'none')}
    for s, t in _idle(window, busy):
        if t - s < shortest_ns:
            continue
        key = next((k for k, iv in tops.items()
                    if any(a <= s < b for a, b in iv)), 'none')
        out[key] += (t - s) / 1e9
    return out


def _edges(window: Interval, busy: Sequence[Interval]) -> Optional[float]:
    """Seconds of idle before the window's first device op and after its
    last: the window's own opening and closing, counted in the idle share
    and in its split."""
    if not busy:
        return None
    return (busy[0][0] - window[0] + window[1] - busy[-1][1]) / 1e9


def readings(recorded, window: Interval, busy: Sequence[Interval]
             ) -> Dict[str, object]:
    """The traced window's readings that have something to read."""
    out = {'loader_wait.train': loader_wait(recorded, window),
           'idle_in_fetch.train': idle_in_fetch(recorded, window, busy),
           'host_step.train': host_step(recorded, window),
           'augment_share.train': device_share(recorded, TRAIN_AUGMENT,
                                               window),
           'update_share.train': device_share(recorded, STEP_UPDATE,
                                              window),
           'idle_split': idle_split(recorded, window, busy),
           'gap_starts': gap_starts(recorded, window, busy),
           'idle_at_edges_s': _edges(window, busy),
           'window_s': (window[1] - window[0]) / 1e9,
           'busy_s': _length(busy) / 1e9}
    return {k: v for k, v in out.items() if v is not None}


def per_span(recorded) -> Dict[str, Dict[str, float]]:
    """Each span name's count and mean host (and device) milliseconds."""
    out = {}
    for name in sorted({s.name for s in recorded}):
        mine = [s for s in recorded if s.name == name]
        row = {'n': len(mine), 'host_ms': sum(
            s.end_ns - s.start_ns for s in mine) / len(mine) / 1e6}
        dev = [s.device_s for s in mine if s.device_s is not None]
        if dev:
            row['device_ms'] = 1e3 * sum(dev) / len(dev)
        out[name] = row
    return out


def main(argv=None, device: str = 'cuda', look_for_chip: bool = True,
         root: Path = HERE) -> int:
    """``run.main`` with the recorder on; prints the spans' line after
    its result line. Returns ``run.main``'s exit code."""
    from bench_h100.drivers import train
    from unet_tpu_torch.utils.profiling import spans
    probes = []

    class Probe(train.Probe):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            probes.append(self)
            self.recorded, self.bounds = [], None
            self.first = (self.trace_from if self.ctx.trace
                          else self.open_at) - 1
            if self.ctx.trace and self.window:
                summary = self.window_trace.summary

                def read():
                    self.bounds = window_of(self.window_trace.path)
                    return summary()
                self.window_trace.summary = read

        def before(self, ts):
            i = self.step
            if i == self.first:
                spans.start()
            super().before(ts)
            if self.ctx.trace and i == self.gaps_to:
                self.recorded = spans.stop()
            elif not self.ctx.trace and i == self.device_from:
                # the window's end: the steps after it run under the
                # device's trace
                self.recorded = spans.stop()

    saved = train.Probe
    train.Probe = Probe
    try:
        rc = run.main(argv, device=device, look_for_chip=look_for_chip,
                      root=root)
    finally:
        train.Probe = saved
        if spans._on is not None:
            leftover = spans.stop()
            if probes and not probes[-1].recorded:
                probes[-1].recorded = leftover
    if rc != 0:
        return rc
    probe = probes[-1]
    out = {'per_span': per_span(probe.recorded)}
    if probe.bounds is not None:
        out.update(readings(probe.recorded, *probe.bounds))
    print(json.dumps({'spans': out}), flush=True)
    return 0


if __name__ == '__main__':
    import os
    os.environ.setdefault('USE_FLAX', '0')
    sys.exit(main())
