"""The harness on the CPU at a tiny size: a cell added as files alone is
found and run, and so is a configuration whose network comes as a new
reference module; the seeded weights are the ones they always were;
faults planted under the timed path turn ``correct`` false, the float8
control fails where the program passes, and nothing a run loads is JAX
or the JAX package."""

import ast
import hashlib
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from types import SimpleNamespace

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
    for kind in ('configs', 'traffic', 'workloads', 'metrics', 'reference'):
        shutil.copytree(HERE / kind, root / kind)
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path / 'BENCHMARK.json')
    cfg = json.loads((HERE / 'configs/attention_unet64.json').read_text())
    cfg['model']['base_features'] = 8
    cfg.update(img_size=64, num_workers=2)
    (root / 'configs/tiny.json').write_text(json.dumps(cfg))
    tr = json.loads((HERE / 'traffic/train_b4x8.json').read_text())
    tr.update(batch_size=2, accumulation_steps=2, volumes=200,
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


# SHA-256 over the seeded state's leaves in order (name, then bytes), on
# the CPU, as the harness drew them before a configuration could bring
# its own reference module
SEEDED_STATE_SHA256 = {
    ('attention_unet64', 0):
        '01c9f13588c93df08dacdd204a8ff413e2c79badcb73ef11f94e53409a1f7f8f',
    ('attention_unet64', 1):
        '2acc87d212536672d990a46774d6187e9394026a4514102ea94dfbb0b31728db',
    ('attention_unet64', 2147483647):
        '716be03c37dd762d0c72b2a653811a3427d5109acfb3f90a194ff71128a5419e',
    ('unet64', 0):
        '1923b04eaaf24bcc4a539fb2c7b4e6cfcb68e73671d373ce242554ff135ffb3d',
    ('unet64', 1):
        '9636ad72711faae9f4fe72ce294f9209ef3d83df4898a104c2bb40a8f858e17a',
    ('unet64', 2147483647):
        'fb7b71fb3aa885e17f38edaf1e20dfb5ac493d1d96b2d44b7fb4f6b6404f764f',
}


@pytest.mark.parametrize('config, seed', sorted(SEEDED_STATE_SHA256))
def test_seeded_state_is_bit_for_bit_as_before(config, seed):
    from bench_h100.common import load_named, load_reference
    from bench_h100.weights import seeded_state
    cfg = load_named('configs', config)
    h = hashlib.sha256()
    for k, v in seeded_state(load_reference(cfg), cfg['model'], seed,
                             'cpu').items():
        h.update(k.encode())
        h.update(v.contiguous().numpy().tobytes())
    assert h.hexdigest() == SEEDED_STATE_SHA256[config, seed]


def test_plan_kinds_land_on_their_leaves():
    from bench_h100.common import load_reference
    from bench_h100.weights import seeded_state
    base = load_reference({})
    cfg = {'type': 'unet', 'n_channels': 1, 'n_classes': 2,
           'bilinear': True, 'base_features': 8}
    bn = 'inc.double_conv.1.'
    changed = {bn + 'weight': ('normal', 0.02),        # was ones
               bn + 'bias': ('normal', 3.0),           # was zeros
               bn + 'running_mean': ('ones',),         # was zeros
               'inc.double_conv.4.running_var': ('zeros',)}  # was ones
    arch = SimpleNamespace(
        Net=base.Net,
        init_plan=lambda shapes: {**base.init_plan(shapes), **changed})
    before = seeded_state(base, cfg, 3, 'cpu')
    after = seeded_state(arch, cfg, 3, 'cpu')
    plan = base.init_plan({k: v.shape for k, v in before.items()})
    uniform = [k for k, v in plan.items() if v[0] == 'uniform']
    assert uniform and all(torch.equal(before[k], after[k]) for k in uniform)
    # the normal leaves follow the uniform draw on the same generator, in
    # state-dict order
    gen = torch.Generator().manual_seed(3)
    torch.rand(sum(before[k].numel() for k in uniform), generator=gen)
    z = torch.randn(16, generator=gen)
    assert torch.equal(after[bn + 'weight'], z[:8] * 0.02)
    assert torch.equal(after[bn + 'bias'], z[8:] * 3.0)
    assert torch.equal(after[bn + 'running_mean'], torch.ones(8))
    assert torch.equal(after['inc.double_conv.4.running_var'],
                       torch.zeros(8))
    rest = set(before) - set(uniform) - set(changed)
    assert all(torch.equal(before[k], after[k]) for k in rest)
    assert after['inc.double_conv.1.num_batches_tracked'].dtype == torch.long
    for bad in ({bn + 'weight': ('xavier',)}, {'no.such.leaf': ('ones',)}):
        arch.init_plan = (lambda shapes, bad=bad:
                          {**base.init_plan(shapes), **bad})
        with pytest.raises(ValueError):
            seeded_state(arch, cfg, 3, 'cpu')


def test_a_window_past_the_epochs_end_fails(tmp_path, capsys,
                                            small_threads):
    """A traffic whose epoch ends before the run does fails, instead of
    timing the validation pass between two epochs."""
    root = tiny_copy(tmp_path)
    path = root / 'traffic/tiny_train.json'
    tr = json.loads(path.read_text())
    tr['volumes'] = 5      # 16 training slices: 4 steps, fewer than warm-up
    path.write_text(json.dumps(tr))
    with pytest.raises(RuntimeError, match='the epoch ended'):
        run_cell(root, capsys)


def test_a_missing_reference_fails_at_set_up_naming_its_path(tmp_path,
                                                              capsys):
    root = tiny_copy(tmp_path)
    cfg = json.loads((root / 'configs/tiny.json').read_text())
    cfg['reference'] = 'no_such_net'
    (root / 'configs/tiny.json').write_text(json.dumps(cfg))
    with pytest.raises(FileNotFoundError) as err:
        run_cell(root, capsys)
    assert str(root / 'reference' / 'no_such_net.py') in str(err.value)
    cfg['reference'] = '../run'
    (root / 'configs/tiny.json').write_text(json.dumps(cfg))
    with pytest.raises(ValueError):
        run_cell(root, capsys)


ZERO_HEAD = '''"""The bilinear UNet of model.py under another name, its head's
bias starting at zero."""

from bench_h100.reference import model as base

Net, set_fp8, flops_per_slice = base.Net, base.set_fp8, base.flops_per_slice


def init_plan(shapes):
    return {**base.init_plan(shapes), 'outc.conv.bias': ('zeros',)}
'''


def _files(*dirs):
    return sorted(p for d in dirs for p in Path(d).rglob('*'))


def test_a_new_network_comes_as_files_alone(tmp_path, capsys, monkeypatch,
                                            small_threads):
    """A configuration that names a reference module of its own, its
    cell and the cell's entries in BENCHMARK.json, all new files and
    entries under a root of the test's own: the run is correct, the
    program starts from the module's plan, and nothing is written
    outside that root."""
    from bench_h100 import run  # noqa: F401  (imported before the listing)
    from bench_h100.common import derive_seed, load_reference
    from bench_h100.weights import seeded_state
    from unet_tpu_torch.train.trainer import TrainStep
    root = tiny_copy(tmp_path)
    (root / 'reference/unet_zero_head.py').write_text(ZERO_HEAD)
    cfg = json.loads((HERE / 'configs/unet64.json').read_text())
    cfg['model']['base_features'] = 8
    cfg.update(img_size=64, num_workers=2, reference='unet_zero_head')
    (root / 'configs/unet_zero_head.json').write_text(json.dumps(cfg))
    cell = {'config': 'unet_zero_head', 'traffic': 'tiny_train', 'chips': 1}
    (root / 'workloads/zero-head-train.json').write_text(json.dumps(
        {**cell, 'limits': TINY_LIMITS}))
    bench = json.loads((tmp_path / 'BENCHMARK.json').read_text())
    bench['workloads'].append({'name': 'zero-head-train', **cell,
                              'why': 'a network from a new reference file'})
    for m in bench['end_to_end'] + bench['per_layer']:
        m.get('workloads', []).append('zero-head-train')
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(bench))

    received = []
    call = TrainStep.__call__

    def first(ts, *a, **k):
        if not received:
            received.append({n: v.detach().cpu().clone()
                             for n, v in ts.model.state_dict().items()})
        return call(ts, *a, **k)
    monkeypatch.setattr(TrainStep, '__call__', first)
    (tmp_path / 'tmp').mkdir()
    monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path / 'tmp'))
    monkeypatch.setattr(sys, 'dont_write_bytecode', True)
    outside = _files(HERE, ROOT / 'unet_tpu_torch')
    top = sorted(ROOT.iterdir())

    rc, res = run_cell(root, capsys, workload='zero-head-train', seed=9)
    assert rc == 0 and res['correct'], res
    assert set(res['metrics']) == {'train_slices_per_s',
                                   'device_ms_per_slice', 'setup_s'}
    want = seeded_state(load_reference(cfg, root), cfg['model'],
                        derive_seed(9, 'weights'), 'cpu')
    got = received[0]
    assert list(got) == list(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert not want['outc.conv.bias'].any()
    assert _files(HERE, ROOT / 'unet_tpu_torch') == outside
    assert sorted(ROOT.iterdir()) == top
    # the run's scratch directory went with it
    assert not list((tmp_path / 'tmp').glob('bench_h100_*'))


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
