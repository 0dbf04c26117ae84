"""Both train CLIs end to end on the CPU from the same reference .pt:
``unet_tpu.cli.train`` and the port's ``unet_tpu_torch.cli.train``, with
--synthetic --device cpu at 64 px, AttentionUNet base 8, float32,
augmentation off, 2 epochs of 5 super-batches (batch 4 x accumulation
2), the EMA warmup switching at epoch 2, tumors of 12-20% of the image
radius (so validation Dice is a ratio over thousands of tumor pixels,
not tens). Their history.json files must
agree, the port's checkpoint must load into the JAX package
(convert_torch_state_dict, via its predict.load_model) and into the
port's own cli/predict.load_model, and both must give the same logits.

Tolerance: the two frameworks' f32 convolutions sum in other orders, and
AdamW turns that noise in near-zero gradients into up to +-lr per step;
through train-mode BatchNorm on this small model the difference grows
over the 10 steps (tests/test_torch_train.py measures the sensitivity).
Measured at epoch 2: losses 1.0e-3 relative apart, Dice/IoU/accuracy
(thresholded argmax over 8 x 64 x 64 validation pixels, a few flipping
at the decision boundary) 3.5e-3 absolute. Held to 5e-3 relative and
1e-2 absolute; epoch 1 (one EMA-free epoch at lr 1e-4) much tighter.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

torch.set_num_threads(2)

HW, BASE = 64, 8


def _config(tmp_path, name):
    cfg = {
        'model': {'type': 'attention_unet', 'n_channels': 1, 'n_classes': 2,
                  'bilinear': True, 'base_features': BASE,
                  'deep_supervision': False},
        'data': {'root': str(tmp_path / 'none'), 'img_size': HW,
                 'val_ratio': 0.2, 'batch_size': 4, 'num_workers': 2},
        'train': {'epochs': 2, 'lr': 0.001, 'weight_decay': 0.0001,
                  'grad_clip': 1.0, 'accumulation_steps': 2},
        'scheduler': {'type': 'warmup_cosine', 'warmup_epochs': 1,
                      'warmup_lr': 0.0001},
        'ema': {'enabled': True, 'decay': 0.9, 'warmup_epochs': 1},
        'early_stopping': {'enabled': True, 'patience': 30,
                           'monitor': 'class_dice.tumor', 'mode': 'max'},
        'loss': {'type': 'dice_bce', 'balanced_class_weight': 0.5,
                 'ce_weight': 1.0, 'dice_weight': 1.0},
        'augmentation': {'enabled': False},
        'output': {'save_dir': str(tmp_path / 'runs'),
                   'experiment_name': name, 'save_last': True,
                   'save_best': True},
        'seed': 42,
        'device': '',
        'tpu': {'compute_dtype': 'float32', 'data_parallel': 1},
    }
    p = tmp_path / f'{name}.yaml'
    p.write_text(yaml.safe_dump(cfg))
    return p, cfg


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    from unet_tpu.cli import train as jax_cli
    from unet_tpu_torch.cli import train as port_cli
    from unet_tpu_torch.models import create_model

    tmp = tmp_path_factory.mktemp('cli')
    init = create_model('attention_unet', base_features=BASE,
                        generator=torch.Generator().manual_seed(0))
    init_pt = tmp / 'init.pt'
    torch.save({'epoch': 0, 'model_state_dict': init.state_dict(),
                'optimizer_state_dict': {}, 'metrics': {}, 'config': {}},
               init_pt)
    common = ['--synthetic', '--synthetic-tumor-radius', '0.12,0.2',
              '--device', 'cpu', '--init-weights', str(init_pt)]
    jcfg, _ = _config(tmp, 'jax')
    old = sys.argv
    sys.argv = ['train', '--config', str(jcfg), *common]
    try:
        jax_cli.main()
    finally:
        sys.argv = old
    pcfg, cfg = _config(tmp, 'port')
    port = port_cli.main(['--config', str(pcfg), *common])
    return {'jax': tmp / 'runs' / 'jax', 'port': Path(port['save_dir']),
            'config': cfg}


def test_histories_agree(runs):
    want = json.loads((runs['jax'] / 'history.json').read_text())
    got = json.loads((runs['port'] / 'history.json').read_text())
    assert set(got) == set(want)
    assert len(got['train_loss']) == 2
    assert got['lr'] == want['lr']
    for k in ('train_loss', 'val_loss'):
        np.testing.assert_allclose(got[k], want[k], rtol=5e-3, err_msg=k)
        np.testing.assert_allclose(got[k][0], want[k][0], rtol=1e-4,
                                   err_msg=k)
    for k in ('val_dice', 'val_iou', 'val_accuracy', 'tumor_dice'):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-2,
                                   err_msg=k)
        np.testing.assert_allclose(got[k][0], want[k][0], rtol=0, atol=1e-4,
                                   err_msg=k)
    assert want['tumor_dice'][1] > 0.5  # the models learned to segment
    assert got['train_loss'][1] < got['train_loss'][0]


def test_checkpoint_layout_and_payload(runs):
    for name in ('last', 'best'):
        d = runs['port'] / 'weights' / name
        meta = json.loads((d / 'meta.json').read_text())
        assert set(meta) == {'epoch', 'step', 'metrics', 'config',
                             'scheduler', 'monitor', 'monitor_value'}
        assert meta['monitor'] == 'class_dice.tumor'
        ckpt = torch.load(d / 'model.pt', map_location='cpu',
                          weights_only=False)
        assert set(ckpt) == {'epoch', 'model_state_dict',
                             'optimizer_state_dict', 'metrics', 'config'}
        assert ckpt['config'] == {**runs['config'], 'device': 'cpu'}
        opt = ckpt['optimizer_state_dict']
        # the real AdamW state: moments for every parameter
        assert opt['state'] and all('exp_avg' in s for s in
                                    opt['state'].values())
    last = json.loads((runs['port'] / 'weights' / 'last' /
                       'meta.json').read_text())
    assert last['epoch'] == 1 and last['step'] == 10


def test_port_checkpoint_loads_in_both_packages(runs):
    """JAX's predict.load_model converts the port's .pt
    (convert_torch_state_dict); the port's load_model reads it too; both
    give the same eval logits (the model tests' tolerance)."""
    import jax.numpy as jnp
    from unet_tpu.cli.predict import load_model as jax_load
    from unet_tpu_torch.cli.predict import load_model as port_load

    pt = runs['port'] / 'weights' / 'last' / 'model.pt'
    jm, variables, jmeta = jax_load(str(pt), dtype=jnp.float32)
    model, meta = port_load(pt, dtype=torch.float32, device='cpu')
    assert jmeta['epoch'] == meta['epoch'] == 1
    x = np.random.default_rng(0).standard_normal(
        (2, HW, HW, 1)).astype(np.float32)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=2e-2, atol=1e-3)


def test_not_ported_flags_fail_at_parsing():
    """(Named for when some of these flags stopped at parsing.) The train
    CLI's --cache and multi-process flags and predict's --spatial-shard
    are ported and parse."""
    from unet_tpu_torch.cli import predict as predict_cli
    from unet_tpu_torch.cli import train as port_cli
    args = port_cli.parse_args([
        '--synthetic', '--cache', 'c.bin', '--coordinator', 'h:1234',
        '--num-processes', '2', '--process-id', '1'])
    assert (args.cache, args.coordinator, args.num_processes,
            args.process_id) == ('c.bin', 'h:1234', 2, 1)
    args = predict_cli.parse_args(['--weights', 'w.pt', '--source', 's',
                                   '--spatial-shard'])
    assert args.spatial_shard


def test_cuda_is_required_unless_cpu_is_asked(tmp_path, monkeypatch):
    from unet_tpu_torch.cli import train as port_cli
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    cfg, _ = _config(tmp_path, 'cuda')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        port_cli.main(['--config', str(cfg), '--synthetic'])


# ---- --resume, --profile-dir and plots, on a smaller UNet (base 4,
# 32 px, 36 training slices: 9 microbatches of 4, accumulation 2, so 5
# optimizer steps per epoch with the leftover flush), as tests/test_cli.py
# drives the JAX CLI

def _small_config(tmp_path, name, epochs, scheduler=None, ema=None,
                  augment=False):
    cfg = {
        'model': {'type': 'unet', 'n_channels': 1, 'n_classes': 2,
                  'bilinear': True, 'base_features': 4,
                  'deep_supervision': False},
        'data': {'root': str(tmp_path / 'none'), 'img_size': 32,
                 'val_ratio': 0.2, 'batch_size': 4, 'num_workers': 2},
        'train': {'epochs': epochs, 'lr': 0.001, 'weight_decay': 0.0001,
                  'grad_clip': 1.0, 'accumulation_steps': 2},
        'scheduler': scheduler or {'type': 'cosine_annealing',
                                   'min_lr': 1e-6},
        'ema': ema or {'enabled': False},
        'early_stopping': {'enabled': True, 'patience': 30,
                           'monitor': 'class_dice.tumor', 'mode': 'max'},
        'loss': {'type': 'dice_bce', 'balanced_class_weight': 0.5,
                 'ce_weight': 1.0, 'dice_weight': 1.0},
        'augmentation': {'enabled': augment},
        'output': {'save_dir': str(tmp_path / 'runs'),
                   'experiment_name': 'test', 'save_last': True,
                   'save_best': True},
        'seed': 42,
        'device': 'cpu',
        'tpu': {'compute_dtype': 'float32'},
    }
    p = tmp_path / f'{name}.yaml'
    p.write_text(yaml.safe_dump(cfg))
    return p


def _train(cfg, name, *extra):
    from unet_tpu_torch.cli import train as port_cli
    return port_cli.main(['--config', str(cfg), '--synthetic', '--name',
                          name, *extra])


def _meta(run, name='last'):
    return json.loads((run / 'weights' / name / 'meta.json').read_text())


@pytest.fixture(scope='module')
def resumed(tmp_path_factory):
    """A 4-epoch run, a 2-epoch run, and two resumes of the latter to
    4 epochs, under cosine annealing (as tests/test_cli.py)."""
    tmp = tmp_path_factory.mktemp('resume')
    out = {'h4': _train(_small_config(tmp, 'c4', 4), 'full')}
    _train(_small_config(tmp, 'c2', 2), 'part')
    out['part_last'] = tmp / 'runs' / 'part' / 'weights' / 'last'
    c4 = _small_config(tmp, 'c4b', 4)
    out['res1'] = _train(c4, 'res1', '--resume', str(out['part_last']))
    out['res2'] = _train(c4, 'res2', '--resume',
                         str(out['part_last'] / 'model.pt'))
    out['runs'] = tmp / 'runs'
    return out


def test_resume_invariance(resumed):
    """The step counter continues, two resumes from one checkpoint give
    identical traces, and the resumed epoch 3 starts from the trained
    weights (its loss is below a fresh run's epoch 1)."""
    runs = resumed['runs']
    assert _meta(runs / 'full')['step'] == 4 * 5
    assert _meta(runs / 'part')['step'] == 10
    h1, h2 = resumed['res1'], resumed['res2']
    assert len(h1['train_loss']) == 2
    meta = _meta(runs / 'res1')
    assert meta['epoch'] == 3 and meta['step'] == 4 * 5
    assert h1['train_loss'] == h2['train_loss']
    assert h1['val_loss'] == h2['val_loss']
    assert h1['train_loss'][0] < resumed['h4']['train_loss'][0]
    assert abs(h1['train_loss'][-1] - resumed['h4']['train_loss'][-1]) < 0.5


def test_resume_writes_what_a_resume_reads(resumed):
    from unet_tpu_torch.train.callbacks import CheckpointManager
    for name in ('last', 'best'):
        d = resumed['runs'] / 'res1' / 'weights' / name
        assert CheckpointManager.restorable(d)
        ts = torch.load(d / 'train_state.pt', weights_only=False)
        assert set(ts) == {'model_state_dict', 'ema', 'aug_step'}
    # the best tracker came from the resumed run's best: a resumed epoch
    # is saved as best only if it beats that value
    part_best = _meta(resumed['runs'] / 'part', 'best')['monitor_value']
    assert _meta(resumed['runs'] / 'res1', 'best')['monitor_value'] \
        >= part_best


def test_plots_are_written(resumed):
    from unet_tpu_torch.utils.plots import have_matplotlib
    if not have_matplotlib():
        pytest.fail('matplotlib is installed here; the plots must be drawn')
    for run in ('full', 'part', 'res1'):
        for png in ('training_curves.png', 'val_predictions.png'):
            assert (resumed['runs'] / run / png).stat().st_size > 0, (run,
                                                                      png)


def test_plots_skipped_without_matplotlib(tmp_path, monkeypatch, capsys):
    from unet_tpu_torch.utils import plots
    monkeypatch.setattr(plots, 'have_matplotlib', lambda: False)
    _train(_small_config(tmp_path, 'c1', 1), 'noplots')
    assert plots.SKIP_MESSAGE in capsys.readouterr().out
    assert not (tmp_path / 'runs' / 'noplots' / 'training_curves.png').exists()


def test_resume_replays_an_uninterrupted_run(tmp_path):
    """With a scheduler that does not depend on the total epoch count
    (plateau), EMA switching on after epoch 1 and augmentation on, a run
    resumed at epoch 3 sees the same shuffles and augmentation draws as
    an uninterrupted run: epochs 3 and 4 and the final weights match it
    exactly."""
    kw = dict(scheduler={'type': 'reduce_on_plateau', 'patience': 10},
              ema={'enabled': True, 'decay': 0.9, 'warmup_epochs': 1},
              augment=True)
    full = _train(_small_config(tmp_path, 'f4', 4, **kw), 'full')
    _train(_small_config(tmp_path, 'p2', 2, **kw), 'part')
    res = _train(_small_config(tmp_path, 'r4', 4, **kw), 'res', '--resume',
                 str(tmp_path / 'runs' / 'part' / 'weights' / 'last'))
    for k in ('train_loss', 'val_loss', 'tumor_dice', 'lr'):
        assert res[k] == full[k][2:], k
    a = torch.load(tmp_path / 'runs' / 'full' / 'weights' / 'last' /
                   'train_state.pt', weights_only=False)
    b = torch.load(tmp_path / 'runs' / 'res' / 'weights' / 'last' /
                   'train_state.pt', weights_only=False)
    assert a['aug_step'] == b['aug_step'] == 4 * 5
    for k, v in a['model_state_dict'].items():
        assert torch.equal(v, b['model_state_dict'][k]), k
    assert a['ema']['updates'] == b['ema']['updates']


def test_resume_auto_continues_the_run_in_place(tmp_path):
    _train(_small_config(tmp_path, 'c1', 1), 'auto_exp')
    run = tmp_path / 'runs' / 'auto_exp'
    assert _meta(run)['epoch'] == 0
    h = _train(_small_config(tmp_path, 'c3', 3), 'auto_exp', '--resume',
               'auto')
    assert len(h['train_loss']) == 2  # epochs 2..3 only
    assert h['save_dir'] == str(run)
    meta = _meta(run)
    assert meta['epoch'] == 2 and meta['step'] == 3 * 5
    assert sorted(p.name for p in (tmp_path / 'runs').iterdir()) == [
        'auto_exp']


def test_resume_auto_without_a_checkpoint_starts_fresh(tmp_path, capsys):
    h = _train(_small_config(tmp_path, 'c1', 1), 'fresh', '--resume', 'auto')
    assert len(h['train_loss']) == 1
    assert 'starting fresh' in capsys.readouterr().out
    assert _meta(tmp_path / 'runs' / 'fresh')['epoch'] == 0


def test_profile_dir_writes_a_trace_of_the_first_epoch(tmp_path):
    prof = tmp_path / 'prof'
    _train(_small_config(tmp_path, 'c2', 2), 'prof', '--profile-dir',
           str(prof))
    traces = list(prof.glob('trace_*.json'))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())['traceEvents']
    names = {e.get('name', '') for e in events}
    assert any('conv' in n for n in names)
