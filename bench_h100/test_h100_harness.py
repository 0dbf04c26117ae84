"""The harness on the CPU at a tiny size: a cell added as files alone is
found and run, faults planted under the timed path turn ``correct``
false, the float8 control fails where the program passes, and nothing a
run loads is JAX or the JAX package."""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
TINY_LIMITS = {'stats': 0.005, 'change': 0.5, 'grad_median': 0.2,
               'tracked': 0.0, 'rows': 0.0, 'draws': 0.0,
               'window_counts': 0.0, 'window_nonfinite': 0.0}


def tiny_copy(tmp_path):
    """A checkout holding BENCHMARK.json and the benchmark's data files,
    plus one new cell, ``tiny-train``, and its own configuration and
    traffic, all added as files."""
    root = tmp_path / 'bench_h100'
    for kind in ('configs', 'traffic', 'workloads', 'metrics'):
        shutil.copytree(HERE / kind, root / kind)
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path / 'BENCHMARK.json')
    cfg = json.loads((HERE / 'configs/attention_unet64.json').read_text())
    cfg['model']['base_features'] = 8
    cfg.update(img_size=64, num_workers=2)
    (root / 'configs/tiny.json').write_text(json.dumps(cfg))
    tr = json.loads((HERE / 'traffic/train_b4x8.json').read_text())
    tr.update(batch_size=2, accumulation_steps=2, volumes=20,
              slices_per_volume=4, pool_slices=16, warmup_steps=3,
              trace_after_steps=0, trace_steps=1, gap_steps=1)
    (root / 'traffic/tiny_train.json').write_text(json.dumps(tr))
    (root / 'workloads/tiny-train.json').write_text(json.dumps(
        {'config': 'tiny', 'traffic': 'tiny_train', 'chips': 1,
         'limits': TINY_LIMITS}))
    return root


def run_cell(root, capsys, workload='tiny-train', seed=5, trace=0):
    from bench_h100 import run
    rc = run.main(['--workload', workload, '--seed', str(seed), '--seconds',
                   '1', '--trace', str(trace)], device='cpu',
                  look_for_chip=False, root=root)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if rc == 0 else None)


@pytest.fixture
def small_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_new_cell_runs_from_files_alone(tmp_path, capsys, small_threads):
    root = tiny_copy(tmp_path)
    rc, res = run_cell(root, capsys)
    assert rc == 0 and res['correct'], res
    assert res['attempted'] > 0 and res['failed'] == 0
    assert set(res['metrics']) == {'setup_s'}
    assert list(res)[-1] == 'compared'
    assert set(res['compared']) == set(TINY_LIMITS)
    assert res['device']['platform'] == 'cpu'
    rc, res = run_cell(root, capsys, trace=1, seed=6)
    assert rc == 0 and res['correct']
    assert res['device']['window_s'] > 0 and 'breakdown' in res


def _unchanged_state(monkeypatch):
    from unet_tpu_torch.train.trainer import TrainStep

    def frozen(self, images, masks, lr, mb_mask, ema=None):
        loss = self.accumulate(images, masks, mb_mask)
        self.steps += 1
        return loss
    monkeypatch.setattr(TrainStep, '__call__', frozen)


def _half_batch(monkeypatch):
    from unet_tpu_torch.train.trainer import TrainStep
    accumulate = TrainStep.accumulate

    def half(self, images, masks, mb_mask):
        keep = images.shape[1] // 2
        return accumulate(self, images[:, :keep], masks[:, :keep], mb_mask)
    monkeypatch.setattr(TrainStep, 'accumulate', half)


def _frozen_after_warmup(monkeypatch):
    """The step switches path once the correctness steps are behind
    it: from its fifth call on it leaves the optimizer out."""
    from unet_tpu_torch.train.trainer import TrainStep
    call = TrainStep.__call__

    def switched(self, images, masks, lr, mb_mask, ema=None):
        if self.steps < 4:
            return call(self, images, masks, lr, mb_mask, ema)
        loss = self.accumulate(images, masks, mb_mask)
        self.steps += 1
        return loss
    monkeypatch.setattr(TrainStep, '__call__', switched)


def _no_clip(monkeypatch):
    from unet_tpu_torch.train import trainer
    monkeypatch.setattr(trainer, 'clip_by_global_norm', lambda *a, **k: None)


def _altered_rows(monkeypatch):
    from unet_tpu_torch.data import augmentations
    aug = augmentations.augment_batch_seeded

    def altered(images, masks, *a, **k):
        return aug(images.flip(-1), masks, *a, **k)
    monkeypatch.setattr(augmentations, 'augment_batch_seeded', altered)


@pytest.mark.parametrize('fault', [_unchanged_state, _half_batch,
                                   _frozen_after_warmup, _no_clip,
                                   _altered_rows])
def test_fault_under_the_timed_path_is_not_correct(tmp_path, capsys,
                                                   monkeypatch, small_threads,
                                                   fault):
    root = tiny_copy(tmp_path)
    fault(monkeypatch)
    rc, res = run_cell(root, capsys)
    assert rc == 0
    assert not res['correct'], res['compared']


def test_control_fails_where_the_program_passes(tmp_path, small_threads):
    from bench_h100.common import make_context
    from bench_h100.drivers import train
    root = tiny_copy(tmp_path)
    ctx = make_context('tiny-train', 7, 0, device='cpu', root=root)
    try:
        out = train.judge(ctx, train.drive(ctx, window=False), control=True)
    finally:
        shutil.rmtree(ctx.tmp, ignore_errors=True)
    assert out['program']['stats'] <= TINY_LIMITS['stats']
    assert out['control']['stats'] > TINY_LIMITS['stats']
    assert out['half_batch']['stats'] > TINY_LIMITS['stats']


@pytest.mark.chip
def test_control_fails_at_the_cells_size_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    from bench_h100.common import make_context, set_cache_dirs
    from bench_h100.drivers import train
    set_cache_dirs()
    for workload in ('attn64-train-b4x8', 'unet64-train-b4x8'):
        for seed in (1, 2, 3):
            ctx = make_context(workload, seed, 0)
            try:
                out = train.judge(ctx, train.drive(ctx, window=False),
                                  control=True)
            finally:
                shutil.rmtree(ctx.tmp, ignore_errors=True)
            lim = ctx.limits['stats']
            assert out['program']['stats'] <= lim
            assert out['control']['stats'] > lim
            assert out['half_batch']['stats'] > lim


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split('.')[0])
    return names


def test_nothing_imports_jax_and_the_reference_nothing_of_the_program():
    for path in HERE.rglob('*.py'):
        assert not _top_level_imports(path) & {'jax', 'jaxlib', 'flax',
                                                'unet_tpu'}, path
    for path in (HERE / 'reference').glob('*.py'):
        assert 'unet_tpu_torch' not in _top_level_imports(path), path
    code = ('import sys; sys.path.insert(0, sys.argv[1]);'
            'import bench_h100.run, bench_h100.drivers.train, '
            'bench_h100.limits, unet_tpu_torch.cli.train;'
            'print(sorted({m.split(".")[0] for m in sys.modules}))')
    loaded = json.loads(subprocess.run(
        [sys.executable, '-c', code, str(ROOT)], capture_output=True,
        text=True, check=True).stdout.replace("'", '"'))
    assert not set(loaded) & {'jax', 'jaxlib', 'flax', 'unet_tpu'}
    assert 'unet_tpu_torch' in loaded
    code = ('import sys; sys.path.insert(0, sys.argv[1]);'
            'import bench_h100.reference.train, bench_h100.reference.model;'
            'print("unet_tpu_torch" in {m.split(".")[0] for m in sys.modules})')
    assert subprocess.run([sys.executable, '-c', code, str(ROOT)],
                          capture_output=True, text=True,
                          check=True).stdout.strip() == 'False'


def test_forbidden_names_compare_whole(monkeypatch):
    from bench_h100.common import forbidden_modules
    monkeypatch.setitem(sys.modules, 'unet_tpu_torch_probe', sys)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, 'unet_tpu.probe', sys)
    assert forbidden_modules() == ['unet_tpu']
