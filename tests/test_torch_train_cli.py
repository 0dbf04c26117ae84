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


def test_not_ported_flags_fail_at_parsing(capsys):
    from unet_tpu_torch.cli import train as port_cli
    for flag, value in (('--resume', 'auto'), ('--cache', 'c.bin'),
                        ('--profile-dir', 'p'), ('--num-processes', '2')):
        with pytest.raises(SystemExit):
            port_cli.parse_args(['--synthetic', flag, value])
        assert flag in capsys.readouterr().err


def test_cuda_is_required_unless_cpu_is_asked(tmp_path, monkeypatch):
    from unet_tpu_torch.cli import train as port_cli
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    cfg, _ = _config(tmp_path, 'cuda')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        port_cli.main(['--config', str(cfg), '--synthetic'])
