"""The port's export CLI (unet_tpu_torch/cli/export_torch.py) and
``cli/predict.py::load_model`` on the port's checkpoint directory, on the
CPU, against the JAX package: a directory written by the port's
``CheckpointManager`` (the train CLI's layout, ``model.pt``,
``meta.json``, ``train_state.pt``) exports to a reference-format ``.pt``
with the keys JAX's ``save_torch_checkpoint`` writes, the state dict of
``model.pt`` tensor for tensor, and JAX's ``load_model`` serves it with
the port's eval logits to the f32 bound of the cross-load in
tests/test_torch_train_cli.py (rtol 2e-2, atol 1e-3)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

MODELS = {
    'attention_unet': {'type': 'attention_unet', 'bilinear': True},
    'unet_transposed': {'type': 'unet', 'bilinear': False},
}


def _config(kind):
    return {'model': {**MODELS[kind], 'n_channels': 1, 'n_classes': 2,
                      'base_features': 4, 'deep_supervision': False},
            'train': {'lr': 0.001, 'weight_decay': 0.0001},
            'tpu': {'compute_dtype': 'float32'}}


@pytest.fixture(scope='module', params=sorted(MODELS))
def checkpoint(request, tmp_path_factory):
    """A port checkpoint directory (epoch 4, one AdamW step taken) of
    weights drawn in the JAX model's tree."""
    from unet_tpu.models import create_model as jax_create_model
    from unet_tpu_torch.models import create_model
    from unet_tpu_torch.train.callbacks import CheckpointManager
    from unet_tpu_torch.train.trainer import create_optimizer
    from unet_tpu_torch.utils.torch_port import state_dict_from_jax
    from torch_port_helpers import jax_variables

    kind = request.param
    cfg = _config(kind)
    m = cfg['model']
    variables = jax_variables(jax_create_model(
        m['type'], base_features=4, bilinear=m['bilinear']), seed=5)
    model = create_model(m['type'], base_features=4, bilinear=m['bilinear'])
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    opt = create_optimizer(model, 1e-3)
    model(torch.zeros(2, 1, 32, 32)).sum().backward()
    opt.step()
    tmp = tmp_path_factory.mktemp(f'export_{kind}')
    manager = CheckpointManager(tmp / 'weights')
    metrics = {'loss': 0.25, 'class_dice': {'tumor': 0.75}}
    manager.save(model.state_dict(), opt.state_dict(), epoch=4,
                 metrics=metrics, config=cfg, step=12,
                 train_state={'model_state_dict': model.state_dict()})
    return {'kind': kind, 'dir': tmp / 'weights' / 'best', 'cfg': cfg,
            'metrics': metrics, 'tmp': tmp}


@pytest.fixture(scope='module')
def exported(checkpoint):
    from unet_tpu_torch.cli import export_torch
    out = checkpoint['tmp'] / 'out' / 'best.pt'
    meta = export_torch.main(['--weights', str(checkpoint['dir']),
                              '--output', str(out), '--device', 'cpu'])
    return out, meta


def test_export_payload_is_the_reference_format(checkpoint, exported,
                                                tmp_path):
    """The keys JAX's save_torch_checkpoint writes; the state dict of
    model.pt tensor for tensor; epoch, metrics and config of meta.json."""
    from unet_tpu.models import create_model as jax_create_model
    from unet_tpu.utils.torch_port import save_torch_checkpoint
    from torch_port_helpers import jax_variables

    out, meta = exported
    got = torch.load(out, weights_only=False)
    m = checkpoint['cfg']['model']
    jax_pt = tmp_path / 'jax.pt'
    save_torch_checkpoint(jax_pt, jax_variables(jax_create_model(
        m['type'], base_features=4, bilinear=m['bilinear'])),
        config=checkpoint['cfg'], epoch=4, metrics=checkpoint['metrics'])
    want = torch.load(jax_pt, weights_only=False)
    assert set(got) == set(want)
    assert set(got['model_state_dict']) == set(want['model_state_dict'])
    src = torch.load(checkpoint['dir'] / 'model.pt', weights_only=False)
    for k, v in src['model_state_dict'].items():
        assert torch.equal(got['model_state_dict'][k], v), k
    assert meta['epoch'] == got['epoch'] == 4
    assert got['metrics'] == checkpoint['metrics']
    assert got['config'] == checkpoint['cfg']
    # the run's own AdamW state: moments for every parameter
    state = got['optimizer_state_dict']['state']
    assert len(state) == sum(1 for k in src['model_state_dict'] if not
                             k.endswith(('running_mean', 'running_var',
                                         'num_batches_tracked')))
    assert all('exp_avg' in s for s in state.values())


def test_jax_load_model_serves_the_export(checkpoint, exported):
    import jax.numpy as jnp
    from unet_tpu.cli.predict import load_model as jax_load
    from unet_tpu_torch.cli.predict import load_model

    out, _ = exported
    jm, variables, jmeta = jax_load(str(out), dtype=jnp.float32)
    model, meta = load_model(out, device='cpu')
    assert jmeta['epoch'] == meta['epoch'] == 4
    x = np.random.default_rng(0).standard_normal(
        (2, 32, 32, 1)).astype(np.float32)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=2e-2, atol=1e-3)


def test_load_model_reads_the_checkpoint_directory(checkpoint, exported):
    """The directory and its export load to the same model: equal eval
    logits; epoch and metrics from meta.json."""
    from unet_tpu_torch.cli.predict import load_model

    out, _ = exported
    from_dir, meta = load_model(checkpoint['dir'], device='cpu')
    from_pt, _ = load_model(out, device='cpu')
    assert meta['epoch'] == 4 and meta['metrics'] == checkpoint['metrics']
    assert meta['config'] == checkpoint['cfg']
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 1, 32, 32)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(from_dir(x), from_pt(x))


def test_export_refuses_a_directory_without_model_pt(tmp_path):
    from unet_tpu_torch.cli import export_torch
    (tmp_path / 'meta.json').write_text('{}')
    with pytest.raises(ValueError, match='export_torch'):
        export_torch.main(['--weights', str(tmp_path), '--output',
                           str(tmp_path / 'o.pt'), '--device', 'cpu'])
    assert not (tmp_path / 'o.pt').exists()


def test_export_needs_cuda_unless_told_cpu(checkpoint, tmp_path,
                                           monkeypatch):
    """The default device is CUDA: without it the CLI raises before it
    writes anything."""
    from unet_tpu_torch.cli import export_torch
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        export_torch.main(['--weights', str(checkpoint['dir']), '--output',
                           str(tmp_path / 'o.pt')])
    assert not (tmp_path / 'o.pt').exists()
