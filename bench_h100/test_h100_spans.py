"""The span readings (``spans.py``) on hand-built spans and busy intervals
with known answers, clipped at the window's edges; a CPU run of a cell
with the recorder on; and on the card, that the program's spans and the
profiler's kernel timestamps share one clock."""

import json

import pytest
import torch

from bench_h100 import spans as reader
from bench_h100.test_h100_harness import tiny_copy
from unet_tpu_torch.utils.profiling import (STEP_UPDATE, TRAIN_AUGMENT,
                                            TRAIN_FETCH, TRAIN_STEP, Span)

MS = 1e6   # ns
WINDOW = (0.0, 1000 * MS)


def _span(name, start_ms, end_ms, device_s=None, parent=None):
    return Span(id=0, name=name, start_ns=int(start_ms * MS),
                end_ns=int(end_ms * MS), thread=1, parent=parent,
                device_s=device_s)


# a loop of two steps and the edges of two more, over a 1-s window:
# fetch, augment and step on the loop thread, updates inside the steps
TIMELINE = [
    _span(TRAIN_AUGMENT, -150, -100, device_s=0.5),   # entered before
    _span(TRAIN_FETCH, -100, 50),
    _span(TRAIN_AUGMENT, 50, 100, device_s=0.02),
    _span(TRAIN_STEP, 100, 390),
    _span(STEP_UPDATE, 300, 390, device_s=0.005),
    _span(TRAIN_FETCH, 400, 450),
    _span(TRAIN_AUGMENT, 450, 500, device_s=0.03),
    _span(TRAIN_STEP, 500, 940),
    _span(STEP_UPDATE, 800, 940, device_s=0.005),
    _span(TRAIN_FETCH, 950, 1100),
    _span(TRAIN_STEP, 1200, 1300),                    # after the window
]
# idle: 30-60 ms (fetch, then augment) and 395-480 ms (none, fetch,
# augment): 115 ms
BUSY = [(0.0, 30 * MS), (60 * MS, 395 * MS), (480 * MS, 1000 * MS)]


def test_readings_on_a_known_timeline():
    out = reader.readings(TIMELINE, WINDOW, BUSY)
    approx = pytest.approx
    assert out['loader_wait.train'] == approx(15.0)      # 50 + 50 + 50
    assert out['idle_in_fetch.train'] == approx(7.0)     # 20 + 50
    assert out['host_step.train'] == approx(73.0)        # 290 + 440
    assert out['augment_share.train'] == approx(5.0)     # 20 + 30 ms
    assert out['update_share.train'] == approx(1.0)      # 5 + 5 ms
    assert out['idle_split'] == approx(
        {'fetch': 7.0, 'augment': 4.0, 'step': 0.0, 'none': 0.5})
    assert sum(out['idle_split'].values()) == approx(
        100 * (1 - out['busy_s'] / out['window_s']))
    assert out['gap_starts'] == approx(
        {'fetch': 0.030, 'augment': 0.0, 'step': 0.0, 'none': 0.085})
    assert out['window_s'] == approx(1.0) and out['busy_s'] == approx(0.885)
    assert out['idle_at_edges_s'] == 0.0


def test_spans_are_clipped_at_the_windows_edges():
    window = (20 * MS, 980 * MS)
    busy = [(20 * MS, 30 * MS), (60 * MS, 980 * MS)]
    out = reader.readings(TIMELINE, window, busy)
    # fetch 20-50, 400-450, 950-980 of a 960-ms window
    assert out['loader_wait.train'] == pytest.approx(100 * 110 / 960)
    assert out['idle_in_fetch.train'] == pytest.approx(100 * 20 / 960)
    assert out['host_step.train'] == pytest.approx(100 * 730 / 960)
    # the augmentation entered at 50 ms counts whole; none ends past it
    assert out['augment_share.train'] == pytest.approx(100 * 50 / 960)
    busy = [(25 * MS, 30 * MS), (60 * MS, 970 * MS)]
    out = reader.readings(TIMELINE, window, busy)
    assert out['idle_at_edges_s'] == pytest.approx(0.015)


def test_nothing_to_read_is_left_out():
    host_only = [_span(s.name, s.start_ns / MS, s.end_ns / MS)
                 for s in TIMELINE]
    out = reader.readings(host_only, WINDOW, [])
    assert set(out) == {'loader_wait.train', 'host_step.train', 'window_s',
                        'busy_s'}
    assert reader.readings([], WINDOW, BUSY).keys() == {
        'idle_split', 'gap_starts', 'idle_at_edges_s', 'window_s', 'busy_s'}


def test_window_of_a_device_trace(tmp_path):
    base = 10 ** 18
    trace = {'baseTimeNanoseconds': base, 'traceEvents': [
        {'ph': 'X', 'cat': 'Trace', 'name': 'session', 'ts': 100.0,
         'dur': 900.0},
        {'ph': 'X', 'cat': 'kernel', 'name': 'k', 'ts': 50.0, 'dur': 100.0},
        {'ph': 'X', 'cat': 'kernel', 'name': 'k', 'ts': 180.0, 'dur': 40.0},
        {'ph': 'X', 'cat': 'gpu_memcpy', 'name': 'c', 'ts': 200.0,
         'dur': 50.0},
        {'ph': 'X', 'cat': 'kernel', 'name': 'k', 'ts': 990.0, 'dur': 50.0},
        {'ph': 'X', 'cat': 'cpu_op', 'name': 'op', 'ts': 300.0, 'dur': 9.0},
    ]}
    path = tmp_path / 'trace.json'
    path.write_text(json.dumps(trace))
    window, busy = reader.window_of(path)
    assert window == (base + 100e3, base + 1000e3)
    assert busy == [(base + 100e3, base + 150e3), (base + 180e3, base + 250e3),
                    (base + 990e3, base + 1000e3)]


def test_cpu_run_prints_the_host_readings(tmp_path, capsys):
    """A traced CPU run prints run.py's line with its metrics, then the
    spans' line with the two host readings and none of the device's."""
    root = tiny_copy(tmp_path)
    bench_path = tmp_path / 'BENCHMARK.json'
    bench = json.loads(bench_path.read_text())
    for m in bench['per_layer']:
        m['workloads'].append('tiny-train')
    bench_path.write_text(json.dumps(bench))
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        rc = reader.main(['--workload', 'tiny-train', '--seed',
                          str(2 ** 31 + 11), '--seconds', '1', '--trace',
                          '1'], device='cpu', look_for_chip=False, root=root)
    finally:
        torch.set_num_threads(n)
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    result, got = json.loads(lines[-2]), json.loads(lines[-1])['spans']
    assert result['correct']
    # the accepted metrics that have something to read on the CPU
    assert set(result['metrics']) == {'mfu.train', 'idle_share.train',
                                      'loop_slices_per_s'}
    five = {'loader_wait.train', 'idle_in_fetch.train', 'host_step.train',
            'augment_share.train', 'update_share.train'}
    assert five & set(got) == {'loader_wait.train', 'host_step.train'}
    for name in ('loader_wait.train', 'host_step.train'):
        assert 0 < got[name] < 100
    # absolute ns in float64 hold 256 ns
    assert got['window_s'] == pytest.approx(result['device']['window_s'],
                                            abs=1e-6)
    for name in (TRAIN_FETCH, TRAIN_AUGMENT, TRAIN_STEP, STEP_UPDATE):
        assert got['per_span'][name]['n'] >= 1
        assert 'device_ms' not in got['per_span'][name]


@pytest.mark.chip
def test_spans_share_the_device_traces_clock(tmp_path):
    """A span around one ``torch.cuda._sleep`` kernel and a synchronise,
    inside a device-only window, contains the kernel's device interval
    to 50 us at either end, and ends within 50 us of the kernel's end:
    the synchronise returns there, so the two clocks differ by no more.
    The span's start leads the kernel by the launch's latency, 26-133 us
    under the profiler on an H100, which says nothing of the clocks."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    from bench_h100.tracing import Window
    from unet_tpu_torch.utils.profiling import annotate, spans
    dev = torch.device('cuda')
    window = Window(tmp_path / 'clock.json', dev, host_ops=False)
    window.warm()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    reps = 5
    window.start()
    spans.start()
    for i in range(reps + 1):   # the first, a warm-up, is not held
        with annotate('clock.check' if i else 'clock.warm', dev):
            torch.cuda._sleep(1_000_000)
            torch.cuda.synchronize()
    recorded = [s for s in spans.stop() if s.name == 'clock.check']
    window.stop()
    data = json.loads(window.path.read_text())
    base = float(data['baseTimeNanoseconds'])
    kernels = sorted((base + 1e3 * e['ts'], base + 1e3 * (e['ts'] + e['dur']))
                     for e in data['traceEvents']
                     if e.get('ph') == 'X' and e.get('cat') == 'kernel')[1:]
    assert len(kernels) == reps == len(recorded)
    slack = [((k0 - s.start_ns) / 1e3, (s.end_ns - k1) / 1e3)
             for s, (k0, k1) in zip(recorded, kernels)]
    print('span edge beyond the kernel, start and end (us):', slack)
    for before, after in slack:
        assert before >= -50 and -50 <= after <= 50
    for s, (k0, k1) in zip(recorded, kernels):
        # the span's events hold the kernel too
        assert s.device_s >= (k1 - k0) / 1e9
