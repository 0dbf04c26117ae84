"""A ``torch.profiler`` window and what the per-layer readers take from
it: device time by operation, the device's busy time within the window,
and the idle gaps named by what the host was doing."""

from __future__ import annotations

import collections
import dataclasses
import gzip
import json
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

MARK = 'bench_window'   # <MARK>.open and <MARK>.close bound the window
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATS = ('cpu_op', 'user_annotation', 'cuda_runtime', 'cuda_driver',
             'python_function')
SHORT_GAP_US = 20.0   # idle gaps below this are pooled, not named


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    op_seconds: Dict[str, float]          # device time by op name
    op_counts: Dict[str, int]
    gaps: List[Tuple[str, float]]         # (what the host did, seconds)

    def kernel(self, function: str) -> Tuple[float, int]:
        """Device seconds and launches of the kernel ``function`` (the
        name before its template or argument list, any instantiation)."""
        hits = [k for k in self.op_seconds if function_name(k) == function]
        return (sum(self.op_seconds[k] for k in hits),
                sum(self.op_counts[k] for k in hits))

    def breakdown(self) -> Dict[str, list]:
        ops = sorted(self.op_seconds.items(), key=lambda kv: -kv[1])[:10]
        return {'device_ops': [[k, v] for k, v in ops],
                'idle_gaps': [[k, v] for k, v in self.gaps[:10]]}


def function_name(op: str) -> str:
    """'void ns::warp_kernel<4>(float const*, ...)' -> 'warp_kernel'."""
    name = op.replace('(anonymous namespace)::', '')
    name = name.split('(', 1)[0].split('<', 1)[0].strip()
    if name.startswith('void '):
        name = name[5:]
    return name.rsplit('::', 1)[-1].strip()


class Window:
    """Start and stop a profiled window from the thread that drives the
    device; ``stop`` synchronises and writes the Chrome trace to
    ``path``, and ``summary`` reduces it. Host ops are recorded on the
    starting thread only, or with ``host_ops=False`` none: then the
    window is the profiling session's span and idle gaps are not
    named."""

    def __init__(self, path: Path, device, host_ops: bool = True):
        self.path, self.device = Path(path), device
        self.host_ops = host_ops
        self._prof = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        # on the CPU (the tests) the host is the device
        acts = ([ProfilerActivity.CPU]
                if self.host_ops or self.device.type == 'cpu' else [])
        if self.device.type == 'cuda':
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        with torch.profiler.record_function(MARK + '.open'):
            pass

    def warm(self) -> None:
        """Start and stop an empty session: the profiler's first start
        takes seconds, which belong in set-up and not in the window."""
        self.start()
        self.stop()
        self.path.unlink()

    def stop(self) -> None:
        import torch
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        with torch.profiler.record_function(MARK + '.close'):
            pass
        self._prof.__exit__(None, None, None)
        # written at once: a session started before this one is written
        # out takes this one's device events with it
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._prof.export_chrome_trace(str(self.path))
        self._prof = None

    def summary(self) -> TraceSummary:
        """Reduce the written trace: after the measured window, since it
        takes seconds of the host."""
        out = summarise(self.path)
        self.path.unlink()
        return out


def _load(path: Path) -> List[dict]:
    opener = gzip.open if str(path).endswith('.gz') else open
    with opener(path, 'rt') as f:
        data = json.load(f)
    return data['traceEvents'] if isinstance(data, dict) else data


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def summarise(path: Path, top_gaps: int = 200) -> TraceSummary:
    """Reduce a Chrome trace whose window the two annotations bound."""
    events = [e for e in _load(path) if e.get('ph') == 'X']
    marks = {e.get('name'): float(e['ts']) for e in events
             if e.get('name') in (MARK + '.open', MARK + '.close')}
    session = [e for e in events if e.get('cat') == 'Trace']
    if len(marks) == 2:
        w0, w1 = marks[MARK + '.open'], marks[MARK + '.close']
    elif session:   # no host ops recorded: the profiling session's span
        w0 = float(session[0]['ts'])
        w1 = w0 + float(session[0]['dur'])
    else:
        raise RuntimeError('the trace lacks the window\'s bounds')
    dev, ops, counts = [], collections.Counter(), collections.Counter()
    host = []
    for e in events:
        s = float(e['ts'])
        t = s + float(e.get('dur', 0.0))
        cat = e.get('cat', '')
        if cat in DEVICE_CATS:
            s, t = max(s, w0), min(t, w1)
            if t > s:
                dev.append((s, t))
                ops[e['name']] += (t - s) / 1e6
                counts[e['name']] += 1
        elif cat in HOST_CATS and not e.get('name', '').startswith(MARK):
            host.append((s, t, e['name']))
    busy = _union(dev)
    busy_us = sum(t - s for s, t in busy)
    gaps, prev = [], w0
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if w1 > prev:
        gaps.append((prev, w1))
    named = collections.Counter()
    gaps.sort(key=lambda g: g[0] - g[1])
    long = [g for g in gaps[:top_gaps] if g[1] - g[0] >= SHORT_GAP_US]
    if host and long:
        hs = np.array([h[0] for h in host])
        he = np.array([h[1] for h in host])
        names = [h[2] for h in host]
        dur = he - hs
        for gs, ge in long:
            # the innermost host op that covers at least half of the gap
            over = np.minimum(he, ge) - np.maximum(hs, gs)
            cand = np.flatnonzero(over >= 0.5 * (ge - gs))
            name = (names[int(cand[np.argmin(dur[cand])])] if len(cand)
                    else 'host: no op over half the gap')
            named[name] += (ge - gs) / 1e6
    else:
        for gs, ge in long:
            named['host: no op over half the gap'] += (ge - gs) / 1e6
    rest = sum(ge - gs for gs, ge in gaps) / 1e6 - sum(named.values())
    if rest > 0:
        named[f'gaps under {SHORT_GAP_US:g} us or beyond the {top_gaps} '
              'longest'] += rest
    return TraceSummary(window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6,
                        op_seconds=dict(ops), op_counts=dict(counts),
                        gaps=named.most_common())

