"""The program's spans (unet_tpu_torch/utils/profiling.py) on the CPU: off
they record nothing and, profiler or not, open no profiler region; on
they nest by thread and outlive a switch of profiler sessions; ``trace``
writes them into its Chrome trace on the profiler's clock; a train CLI
run records one fetch, augmentation, step and update span per optimizer
step, each child inside its parent, and trains bit for bit as it does
with the recorder off."""

import json
import threading

import pytest
import torch
import yaml

from unet_tpu_torch.utils import profiling
from unet_tpu_torch.utils.profiling import annotate, spans

torch.set_num_threads(2)

CPU = torch.device('cpu')


@pytest.fixture
def recorder():
    """The recorder on for the test; off again whatever the test did."""
    spans.start()
    yield spans
    if spans._on is not None:
        spans.stop()


def test_off_annotate_records_nothing_and_opens_no_region(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, 'record_function',
                        lambda name: opened.append(name))
    assert annotate('a') is annotate('b', CPU)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        with annotate('entered_off') as span:
            assert span is None
            spans.start()
            with annotate('inner'):
                pass
    recorded = spans.stop()
    assert [s.name for s in recorded] == ['inner']
    assert recorded[0].parent is None
    assert opened == []


def test_nested_spans_take_their_parents_from_their_own_thread(recorder):
    entered, release = threading.Event(), threading.Event()

    def worker():
        with annotate('worker'):
            entered.set()
            assert release.wait(10)

    with annotate('outer') as outer:
        t = threading.Thread(target=worker)
        t.start()
        assert entered.wait(10)
        with annotate('inner') as inner:
            with annotate('leaf') as leaf:
                pass
        release.set()
        t.join(10)
        assert not t.is_alive()
    with annotate('after') as after:
        pass
    by_name = {s.name: s for s in recorder.stop()}
    assert set(by_name) == {'outer', 'inner', 'leaf', 'worker', 'after'}
    assert inner.parent == outer.id and leaf.parent == inner.id
    assert outer.parent is None and after.parent is None
    assert by_name['worker'].parent is None
    assert (by_name['worker'].thread != outer.thread
            == threading.get_native_id())
    for s in by_name.values():
        assert s.start_ns <= s.end_ns
    assert outer.start_ns <= inner.start_ns <= leaf.end_ns <= outer.end_ns


def test_span_open_at_stop_is_dropped_and_a_second_start_refused(recorder):
    with pytest.raises(RuntimeError, match='already on'):
        spans.start()
    with annotate('open'):
        with annotate('closed'):
            pass
        recorded = spans.stop()
    assert [s.name for s in recorded] == ['closed']
    with pytest.raises(RuntimeError, match='off'):
        spans.stop()


def test_span_outlives_a_switch_of_profiler_sessions(recorder, tmp_path):
    """As the benchmark's traced runs do inside a train step: one session
    stops and is written, the next starts, then the span closes. (A
    ``record_function`` region doing this crashes the second export.)"""
    cpu = [torch.profiler.ProfilerActivity.CPU]
    for i in range(30):
        first = torch.profiler.profile(activities=cpu)
        first.__enter__()
        with annotate('across'):
            for _ in range(10):
                with annotate('inside'):
                    torch.ones(4) + 1
            first.__exit__(None, None, None)
            first.export_chrome_trace(str(tmp_path / 'first.json'))
            second = torch.profiler.profile(activities=cpu)
            second.__enter__()
        torch.ones(4) + 1
        second.__exit__(None, None, None)
        second.export_chrome_trace(str(tmp_path / 'second.json'))
    names = [s.name for s in recorder.stop()]
    assert names.count('across') == 30 and names.count('inside') == 300


def test_trace_writes_spans_on_the_profilers_clock(tmp_path):
    out = tmp_path / 'trace'
    with profiling.trace(str(out)):
        # a process's first region takes a millisecond to enter
        with torch.profiler.record_function('warm'):
            pass
        with torch.profiler.record_function('around'):
            with annotate('my_span', CPU):
                torch.ones(64, 64) @ torch.ones(64, 64)
                with annotate('my_child'):
                    torch.ones(8) + 1
    assert spans._on is None
    (path,) = out.glob('trace_*.json')
    events = json.loads(path.read_text())['traceEvents']
    around = next(e for e in events if e.get('name') == 'around'
                  and e.get('cat') != profiling.SPAN_CATEGORY)
    mine = {e['name']: e for e in events
            if e.get('cat') == profiling.SPAN_CATEGORY}
    assert set(mine) == {'my_span', 'my_child'}
    span = mine['my_span']
    assert span['ph'] == 'X' and span['tid'] == around['tid']
    assert abs(span['ts'] - around['ts']) < 1e3
    assert abs(span['ts'] + span['dur'] - around['ts'] - around['dur']) < 1e3
    assert mine['my_child']['args']['parent'] == span['args']['id']


def test_cpu_spans_carry_no_device_seconds(recorder, tmp_path):
    with annotate('on_cpu', CPU):
        torch.ones(4) * 2
    (span,) = recorder.stop()
    assert span.device_s is None
    path = tmp_path / 't.json'
    path.write_text(json.dumps({'baseTimeNanoseconds': span.start_ns,
                                'traceEvents': []}))
    profiling.add_spans_to_trace(path, [span])
    (event,) = json.loads(path.read_text())['traceEvents']
    assert event['ts'] == 0 and set(event['args']) == {'id', 'parent'}


# ---- the train CLI: 5 synthetic volumes of 4 slices (one for
# validation), microbatch 4 x accumulation 2, so 2 optimizer steps, with
# augmentation on, at 32 px on a base-4 UNet

STEPS = 2


def _config(tmp_path, name):
    cfg = {
        'model': {'type': 'unet', 'n_channels': 1, 'n_classes': 2,
                  'bilinear': True, 'base_features': 4,
                  'deep_supervision': False},
        'data': {'root': str(tmp_path / 'none'), 'img_size': 32,
                 'val_ratio': 0.2, 'batch_size': 4, 'num_workers': 2},
        'train': {'epochs': 1, 'lr': 0.001, 'weight_decay': 0.0001,
                  'grad_clip': 1.0, 'accumulation_steps': 2},
        'scheduler': {'type': 'cosine_annealing', 'min_lr': 1e-6},
        'ema': {'enabled': True, 'decay': 0.9, 'warmup_epochs': 0},
        'early_stopping': {'enabled': False},
        'loss': {'type': 'dice_bce', 'balanced_class_weight': 0.5,
                 'ce_weight': 1.0, 'dice_weight': 1.0},
        'augmentation': {'enabled': True},
        'output': {'save_dir': str(tmp_path / 'runs'),
                   'experiment_name': name, 'save_last': True,
                   'save_best': False},
        'seed': 7,
        'device': 'cpu',
        'tpu': {'compute_dtype': 'float32'},
    }
    p = tmp_path / f'{name}.yaml'
    p.write_text(yaml.safe_dump(cfg))
    return p


def _train(tmp_path, name):
    from unet_tpu_torch.cli import train
    return train.main(['--config', str(_config(tmp_path, name)),
                       '--synthetic', '--synthetic-volumes', '5',
                       '--synthetic-slices', '4'])


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('spans')
    plain = _train(tmp, 'off')
    spans.start()
    try:
        traced = _train(tmp, 'on')
    finally:
        recorded = spans.stop()
    return plain, traced, recorded


def test_train_run_records_one_span_of_each_per_optimizer_step(runs):
    _, traced, recorded = runs
    assert len(traced['train_loss']) == 1
    by_id = {s.id: s for s in recorded}
    count = {}
    for s in recorded:
        count[s.name] = count.get(s.name, 0) + 1
    for name in (profiling.TRAIN_FETCH, profiling.TRAIN_AUGMENT,
                 profiling.TRAIN_STEP, profiling.STEP_UPDATE):
        assert count[name] == STEPS, (name, count)
    parents = {profiling.STEP_UPDATE: profiling.TRAIN_STEP,
               profiling.LOADER_WAIT: profiling.TRAIN_FETCH,
               profiling.H2D_STAGE: profiling.TRAIN_FETCH}
    under = {}
    for s in recorded:
        if s.parent is None:
            continue
        parent = by_id[s.parent]
        assert parents[s.name] == parent.name, (s, parent)
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
        assert s.thread == parent.thread
        under[s.name] = under.get(s.name, 0) + 1
    # 4 microbatches gathered and 2 super-batches staged, inside fetches
    assert under == {profiling.STEP_UPDATE: STEPS,
                     profiling.LOADER_WAIT: 2 * STEPS,
                     profiling.H2D_STAGE: STEPS}
    top = sorted((s for s in recorded if s.name in (
        profiling.TRAIN_FETCH, profiling.TRAIN_AUGMENT, profiling.TRAIN_STEP)),
        key=lambda s: s.start_ns)
    assert [s.name for s in top] == STEPS * [
        profiling.TRAIN_FETCH, profiling.TRAIN_AUGMENT, profiling.TRAIN_STEP]
    assert all(a.end_ns <= b.start_ns for a, b in zip(top, top[1:]))
    assert all(s.device_s is None for s in recorded)


def test_recorder_leaves_losses_and_weights_bit_identical(runs):
    from pathlib import Path
    plain, traced, _ = runs
    for key in ('train_loss', 'val_loss', 'val_dice', 'tumor_dice'):
        assert plain[key] == traced[key], key
    a, b = (torch.load(Path(r['save_dir']) / 'weights/last/model.pt',
                       map_location='cpu', weights_only=False)
            for r in (plain, traced))
    assert a['model_state_dict'].keys() == b['model_state_dict'].keys()
    for k, v in a['model_state_dict'].items():
        assert torch.equal(v, b['model_state_dict'][k]), k
    assert (plain['kernel_launches'] == traced['kernel_launches'])
