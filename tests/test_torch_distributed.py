"""The port's data-parallel training (unet_tpu_torch/core/, the
BatchLoader's local_slice/pad_tail, global-batch TorchBatchNorm, the
train step's one gradient reduction, global augmentation draws and the
train CLI's multi-process flags) on the CPU over gloo, against the JAX
package and against the port's own single process.

Tolerances:
* BatchNorm over 2 ranks against one process on the whole batch: the
  same float32 sums split in two and added, rtol 1e-5 (as the
  single-process BatchNorm test against flax).
* The 2-rank train step (global batch 8, 4 per rank) against the port's
  own single process on the whole batch: the same float32 arithmetic but
  for the reductions' order, each gradient to 1e-4 of its largest
  magnitude (measured 2.6e-5) and the loss to rtol 1e-6.
* The same against JAX's single-process step, as tests/test_multihost.py
  holds JAX's 2 processes: the loss to rtol 1e-5 and the global gradient
  norm to rtol 1e-3 (measured 1.0e-4). Per tensor the two packages
  differ by up to 5% of a tensor's largest gradient on this 32 px model
  even in one process (measured; its BatchNorms at the 2 x 2 bottleneck
  normalize 32 values per channel), which is why tests/test_torch_train.py
  compares per-tensor gradients on other inputs.
* Every rank ends a step with bitwise the same parameters, buffers and
  EMA: they apply the same reduced gradient.
* The 2-process train CLI against one process: epoch 1 to rtol 1e-4
  (the summation order of the reduced gradient); epoch 2 loose (AdamW
  turns that noise into up to +-lr per step, tests/test_multihost.py).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 240


def _env():
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS='2')
    return env


def _run_ranks(cmd_for_rank, n=2, cwd=REPO):
    """Start ``n`` processes, wait for all (killing every one when any
    outlives TIMEOUT); returns their outputs, asserting rc 0."""
    procs = [subprocess.Popen(cmd_for_rank(r), cwd=cwd, env=_env(),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return outs


def _port():
    from unet_tpu_torch.core.mesh import free_port
    return free_port()


# ---------------------------------------------------------------- sharding

@pytest.mark.parametrize('index,count', [(0, 1), (0, 2), (1, 2), (2, 3)])
def test_shard_for_process_matches_jax(index, count):
    from unet_tpu.core.distributed import shard_for_process as jax_shard
    from unet_tpu_torch.core.distributed import shard_for_process
    items = [f'{v}_slice_{s:04d}.png' for v in range(5) for s in range(3)]
    assert shard_for_process(items, index, count) == jax_shard(
        items, index, count)


class _Indexed:
    """A dataset whose sample i is filled with i."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def load_raw(self, idx):
        return (np.full((2, 3), idx, np.uint8),
                np.full((2, 3), idx % 2, np.uint8))

    load = load_raw


LOADERS = {
    'train': dict(shuffle=True, drop_last=True),
    'val': dict(shuffle=False, pad_tail=True),
    'val_train_order': dict(shuffle=True, pad_tail=True),
}


@pytest.mark.parametrize('kind', sorted(LOADERS))
@pytest.mark.parametrize('index,count', [(0, 2), (1, 2), (3, 4)])
def test_batch_loader_local_rows_match_jax(kind, index, count):
    """Two epochs of each rank's rows, the tail padding and tail_valid
    equal the JAX loader's exactly."""
    from unet_tpu.data.dataset import BatchLoader as JaxLoader
    from unet_tpu_torch.data.dataset import BatchLoader
    ds = _Indexed(19)
    kw = dict(LOADERS[kind], seed=5, num_threads=2, raw_uint8=True,
              local_slice=(index, count))
    got_l, want_l = BatchLoader(ds, 8, **kw), JaxLoader(ds, 8, **kw)
    assert len(got_l) == len(want_l)
    assert [got_l.tail_valid(b) for b in range(len(got_l))] == [
        want_l.tail_valid(b) for b in range(len(want_l))]
    for _ in range(2):
        got, want = list(got_l), list(want_l)
        assert len(got) == len(want) > 0
        for (gi, gm), (wi, wm) in zip(got, want):
            assert gi.shape == (8 // count, 1, 2, 3)
            np.testing.assert_array_equal(gi[:, 0], wi[..., 0])
            np.testing.assert_array_equal(gm, wm)


@pytest.mark.parametrize('kw,match', [
    (dict(drop_last=True, local_slice=(0, 3)), 'not divisible'),
    (dict(local_slice=(0, 2)), 'needs drop_last or pad_tail')])
def test_batch_loader_refuses_what_jax_refuses(kw, match):
    from unet_tpu.data.dataset import BatchLoader as JaxLoader
    from unet_tpu_torch.data.dataset import BatchLoader
    for cls in (BatchLoader, JaxLoader):
        with pytest.raises(ValueError, match=match):
            cls(_Indexed(8), 8, **kw)


def test_skip_epochs_replays_each_ranks_rows():
    from unet_tpu_torch.data.dataset import BatchLoader
    kw = dict(shuffle=True, drop_last=True, seed=3, num_threads=1,
              raw_uint8=True, local_slice=(1, 2))
    full = BatchLoader(_Indexed(21), 4, **kw)
    list(full)
    resumed = BatchLoader(_Indexed(21), 4, **kw)
    resumed.skip_epochs(1)
    for (a, _), (b, _) in zip(full, resumed):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- augmentation

@pytest.mark.parametrize('index', [0, 1])
def test_augmentation_applies_the_global_draws_to_local_rows(index):
    """A rank's augmented rows equal the same rows of the single-process
    call on the whole super-batch (2 microbatches of 2 x 2 rows)."""
    from unet_tpu_torch.data.augmentations import (AugmentConfig,
                                                   augment_batch_seeded,
                                                   local_rows)
    cfg = AugmentConfig(p_elastic=1.0, p_affine=1.0, p_grid=1.0,
                        p_noise=1.0, p_dropout=1.0, elastic_sigma=2.0)
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.random((8, 1, 16, 16), np.float32))
    msk = torch.from_numpy((rng.random((8, 16, 16)) > 0.7).astype(np.uint8))
    want_i, want_m = augment_batch_seeded(img, msk, 43, 5, cfg)
    rows = local_rows(2, 2, index, 2)
    assert rows.tolist() == [2 * index, 2 * index + 1,
                             4 + 2 * index, 5 + 2 * index]
    got_i, got_m = augment_batch_seeded(img[rows], msk[rows], 43, 5, cfg,
                                        local_slice=(index, 2), groups=2)
    np.testing.assert_allclose(got_i.numpy(), want_i[rows].numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got_m.numpy(), want_m[rows].numpy())


# ---------------------------------------------------------------- init

@pytest.mark.parametrize('process_id', [0, 1])
def test_init_raises_when_no_peer_joins(process_id):
    """Two processes asked for, one started: rank 0 times out waiting
    for its peer, rank 1 for the coordinator; neither carries on alone."""
    import torch.distributed as dist
    from unet_tpu_torch.core.distributed import init_distributed
    with pytest.raises((RuntimeError, dist.DistError)):
        init_distributed(f'127.0.0.1:{_port()}', 2, process_id, 'cpu',
                         timeout_seconds=2)
    assert not dist.is_initialized()


def test_init_needs_an_address_and_an_id(capsys):
    from unet_tpu_torch.cli import train as port_cli
    from unet_tpu_torch.core.distributed import init_distributed
    with pytest.raises(ValueError, match='coordinator'):
        init_distributed(None, 2, 0)
    with pytest.raises(SystemExit):
        port_cli.parse_args(['--num-processes', '2', '--process-id', '0'])
    assert '--coordinator' in capsys.readouterr().err


@pytest.mark.parametrize('value,want', [('', 'gloo'), ('gloo', 'gloo'),
                                        ('nccl', 'nccl')])
def test_backend_choice(monkeypatch, value, want):
    from unet_tpu_torch.core import distributed
    monkeypatch.setenv(distributed.BACKEND_ENV, value)
    assert distributed.backend_for('cpu') == want
    if value:
        assert distributed.backend_for('cuda') == want
    else:
        assert distributed.backend_for('cuda') == 'nccl'
    monkeypatch.setenv(distributed.BACKEND_ENV, 'mpi')
    with pytest.raises(ValueError, match='gloo'):
        distributed.backend_for('cpu')


def test_layout_of_ranks():
    from unet_tpu_torch.core import mesh
    assert mesh.local_degree(-1, 'cpu') == 1
    assert mesh.local_degree(None, 'cpu') == 1
    assert mesh.local_degree(3, 'cpu') == 3
    with pytest.raises(ValueError):
        mesh.local_degree(0, 'cpu')
    assert [mesh.global_rank(p, 2, i) for p in (0, 1) for i in (0, 1)] == [
        0, 1, 2, 3]
    assert mesh.rank_device('cuda', 3) == torch.device('cuda', 3)
    assert mesh.rank_device('cpu', 3) == torch.device('cpu')
    mesh.check_global_batch(8, 4)
    with pytest.raises(ValueError, match='divisible'):
        mesh.check_global_batch(6, 4)


# ---------------------------------------------------------------- 2 ranks

def _blobs(rng, n, hw):
    """One disc of tumor per mask, as tests/test_torch_train.py draws."""
    yy, xx = np.mgrid[0:hw, 0:hw]
    masks = np.zeros((n, hw, hw), np.int32)
    for m in masks:
        cy, cx = rng.uniform(hw / 4, 3 * hw / 4, 2)
        m[...] = (yy - cy) ** 2 + (xx - cx) ** 2 < rng.uniform(9, 36)
    return masks


@pytest.fixture(scope='module')
def two_ranks(tmp_path_factory):
    """JAX's single-process step and the port's 2-rank worker
    (tests/torch_dist_worker.py) on the same weights and batch."""
    import jax
    import jax.numpy as jnp
    from unet_tpu.models import create_model as jax_create_model
    from unet_tpu.train import losses as jl
    from unet_tpu_torch.models import create_model
    from unet_tpu_torch.train.losses import create_loss_function
    from unet_tpu_torch.utils.torch_port import state_dict_from_jax
    from torch_port_helpers import jax_variables

    tmp = tmp_path_factory.mktemp('ranks')
    rng = np.random.default_rng(0)
    c = 3
    inputs = dict(
        x=(3 * rng.standard_normal((4, c, 5, 6)) + 1).astype(np.float32),
        g=rng.standard_normal((4, c, 5, 6)).astype(np.float32),
        bn_weight=rng.uniform(0.5, 1.5, c).astype(np.float32),
        bn_bias=rng.standard_normal(c).astype(np.float32),
        bn_running_mean=rng.standard_normal(c).astype(np.float32),
        bn_running_var=rng.uniform(0.5, 2, c).astype(np.float32),
        imgs=rng.standard_normal((8, 32, 32, 1)).astype(np.float32),
        msks=_blobs(rng, 8, 32))
    np.savez(tmp / 'inputs.npz', **inputs)

    jm = jax_create_model('attention_unet', base_features=8)
    variables = jax_variables(jm, 0)
    torch.save(state_dict_from_jax(variables), tmp / 'weights.pt')
    jloss = jl.create_loss_function('dice_bce')

    def loss_of(p):
        outs, _ = jm.apply({'params': p,
                            'batch_stats': variables['batch_stats']},
                           jnp.asarray(inputs['imgs']), train=True,
                           mutable=['batch_stats'])
        return jloss(outs, jnp.asarray(inputs['msks']))

    loss, grads = jax.jit(jax.value_and_grad(loss_of))(variables['params'])
    model = create_model('attention_unet', base_features=8)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    model.train()
    port_loss = create_loss_function('dice_bce')(
        model(torch.from_numpy(inputs['imgs']).permute(0, 3, 1, 2)),
        torch.from_numpy(inputs['msks']))
    port_loss.backward()
    port = _port()
    _run_ranks(lambda r: [sys.executable, 'tests/torch_dist_worker.py',
                          f'127.0.0.1:{port}', str(r), '2', str(tmp)])
    return {'inputs': inputs, 'jax_loss': float(loss),
            'port_loss': port_loss.item(),
            'port_grads': {k: p.grad for k, p in model.named_parameters()},
            'jax_grads': state_dict_from_jax({'params': grads}),
            'ranks': [torch.load(tmp / f'rank{r}.pt', weights_only=False)
                      for r in (0, 1)]}


def test_global_batchnorm_equals_one_process_on_the_whole_batch(two_ranks):
    from unet_tpu_torch.models.layers import TorchBatchNorm
    inp = two_ranks['inputs']
    bn = TorchBatchNorm(inp['x'].shape[1])
    bn.load_state_dict({k: torch.from_numpy(inp[f'bn_{k}'])
                        for k in ('weight', 'bias', 'running_mean',
                                  'running_var')}
                       | {'num_batches_tracked': torch.tensor(0)})
    bn.train()
    x = torch.from_numpy(inp['x']).requires_grad_(True)
    y = bn(x)
    (y * torch.from_numpy(inp['g'])).sum().backward()
    got = [r['bn'] for r in two_ranks['ranks']]

    def close(a, b):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)

    close(torch.cat([g['out'] for g in got]), y.detach())
    close(torch.cat([g['dx'] for g in got]), x.grad)
    # each rank holds the gradient of its own rows' loss; the sum over
    # the ranks is the whole batch's
    close(got[0]['dweight'] + got[1]['dweight'], bn.weight.grad)
    close(got[0]['dbias'] + got[1]['dbias'], bn.bias.grad)
    for g in got:  # the global batch's statistics on every rank
        close(g['running_mean'], bn.running_mean)
        close(g['running_var'], bn.running_var)
        assert int(g['num_batches_tracked']) == 1


def _norm(grads):
    return float(torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads)))


def test_two_rank_step_equals_one_process(two_ranks):
    want = two_ranks['port_grads']
    for r in two_ranks['ranks']:
        np.testing.assert_allclose(float(r['loss']), two_ranks['port_loss'],
                                   rtol=1e-6)
        assert set(r['grads']) == set(want)
        for k, g in r['grads'].items():
            w = want[k].numpy()
            err = np.abs(g.numpy() - w).max()
            assert err <= 1e-4 * max(np.abs(w).max(), 1e-12), (k, err)


def test_two_rank_step_equals_jax_single_process(two_ranks):
    for r in two_ranks['ranks']:
        np.testing.assert_allclose(float(r['loss']), two_ranks['jax_loss'],
                                   rtol=1e-5)
        np.testing.assert_allclose(_norm(r['grads'].values()),
                                   _norm(two_ranks['jax_grads'].values()),
                                   rtol=1e-3)


def test_every_rank_ends_the_step_identical(two_ranks):
    a, b = (r['after'] for r in two_ranks['ranks'])
    for part in ('model', 'ema'):
        assert set(a[part]) == set(b[part])
        for k, v in a[part].items():
            assert torch.equal(v, b[part][k]), (part, k)
    grads = [r['grads'] for r in two_ranks['ranks']]
    for k, g in grads[0].items():
        assert torch.equal(g, grads[1][k]), k


# ---------------------------------------------------------------- train CLI

def _config(tmp, name, epochs=2, data_parallel=None):
    cfg = {
        'model': {'type': 'attention_unet', 'n_channels': 1, 'n_classes': 2,
                  'bilinear': True, 'base_features': 4,
                  'deep_supervision': False},
        'data': {'root': str(tmp / 'none'), 'img_size': 32,
                 'val_ratio': 0.2, 'batch_size': 4, 'num_workers': 2},
        'train': {'epochs': epochs, 'lr': 0.001, 'weight_decay': 0.0001,
                  'grad_clip': 1.0, 'accumulation_steps': 2},
        'scheduler': {'type': 'reduce_on_plateau', 'patience': 10},
        'ema': {'enabled': True, 'decay': 0.9, 'warmup_epochs': 1},
        'early_stopping': {'enabled': True, 'patience': 30,
                           'monitor': 'class_dice.tumor', 'mode': 'max'},
        'loss': {'type': 'dice_bce', 'balanced_class_weight': 0.5,
                 'ce_weight': 1.0, 'dice_weight': 1.0},
        'augmentation': {'enabled': True},
        'output': {'save_dir': str(tmp / 'runs'), 'experiment_name': 'run',
                   'save_last': True, 'save_best': True},
        'seed': 42,
        'device': 'cpu',
        'tpu': {'compute_dtype': 'float32'},
    }
    if data_parallel:
        cfg['tpu']['data_parallel'] = data_parallel
    tmp.mkdir(parents=True, exist_ok=True)
    path = tmp / f'{name}.yaml'
    path.write_text(yaml.safe_dump(cfg))
    return path


# 9 volumes x 4 slices: 28 training slices (7 microbatches of 4, the last
# super-batch a leftover flush) and 8 validation slices (a padded tail
# batch would show in the val loss if pad rows counted)
SYNTH = ['--synthetic', '--synthetic-volumes', '9',
         '--synthetic-tumor-radius', '0.12,0.2']


def _two_process_cli(cfg, *extra):
    port = _port()
    return _run_ranks(lambda r: [
        sys.executable, '-m', 'unet_tpu_torch.cli.train', '--config',
        str(cfg), *SYNTH, '--coordinator', f'127.0.0.1:{port}',
        '--num-processes', '2', '--process-id', str(r), *extra])


def _history(run):
    return json.loads((run / 'history.json').read_text())


@pytest.fixture(scope='module')
def cli_runs(tmp_path_factory):
    from unet_tpu_torch.cli import train as port_cli
    tmp = tmp_path_factory.mktemp('cli')
    single = port_cli.main(['--config', str(_config(tmp / 'one', 'c')),
                            *SYNTH])
    outs = _two_process_cli(_config(tmp / 'two', 'c'))
    two = tmp / 'two' / 'runs' / 'run'
    return {'tmp': tmp, 'single': single, 'outs': outs, 'two': two,
            'two_history': _history(two)}


def test_two_process_cli_matches_one_process(cli_runs):
    want = cli_runs['single']
    got = cli_runs['two_history']
    assert 'Data parallel: 2 ranks, gloo backend' in cli_runs['outs'][0]
    assert 'Warp kernel launches per rank: [0, 0]' in cli_runs['outs'][0]
    assert want['warp_launches'] == [0]
    assert got['lr'] == want['lr']
    for k in ('train_loss', 'val_loss'):
        np.testing.assert_allclose(got[k][0], want[k][0], rtol=1e-4,
                                   err_msg=k)
        np.testing.assert_allclose(got[k], want[k], rtol=2e-2, err_msg=k)
    for k in ('val_dice', 'val_iou', 'val_accuracy', 'tumor_dice'):
        np.testing.assert_allclose(got[k][0], want[k][0], atol=1e-4,
                                   err_msg=k)
        np.testing.assert_allclose(got[k], want[k], atol=5e-2, err_msg=k)
    meta = json.loads((cli_runs['two'] / 'weights' / 'last' /
                       'meta.json').read_text())
    assert meta['epoch'] == 1 and meta['step'] == 2 * 4


def test_only_rank_zero_writes(cli_runs):
    runs = cli_runs['tmp'] / 'two' / 'runs'
    assert sorted(p.name for p in runs.iterdir()) == ['run']
    files = {p.name for p in cli_runs['two'].iterdir()}
    assert {'weights', 'history.json', 'training_curves.png'} <= files
    rank1 = cli_runs['outs'][1]
    assert 'Epoch' not in rank1 and 'Results saved' not in rank1


def test_two_process_resume_auto_continues(cli_runs):
    """Rank 0 finds the run, broadcasts the decision and the checkpoint;
    both ranks continue from epoch 3 in the same run directory."""
    cfg = _config(cli_runs['tmp'] / 'two', 'c3', epochs=3)
    outs = _two_process_cli(cfg, '--resume', 'auto')
    assert f'continuing {cli_runs["two"]}' in outs[0]
    assert 'Resumed from epoch 2 (optimizer step 8)' in outs[0]
    meta = json.loads((cli_runs['two'] / 'weights' / 'last' /
                       'meta.json').read_text())
    assert meta['epoch'] == 2 and meta['step'] == 3 * 4
    assert len(_history(cli_runs['two'])['train_loss']) == 1
    runs = cli_runs['tmp'] / 'two' / 'runs'
    assert sorted(p.name for p in runs.iterdir()) == ['run']


def test_local_ranks_spawned_from_data_parallel(cli_runs, tmp_path):
    """``tpu.data_parallel: 2`` on one command spawns two local ranks,
    which train as the two processes did; ``main`` returns local rank
    0's result, each rank's warp launches among it."""
    cfg = _config(tmp_path, 'dp2', data_parallel=2)
    code = ('import json, sys; from unet_tpu_torch.cli import train; '
            'print("RESULT " + json.dumps(train.main(sys.argv[1:])))')
    proc = subprocess.run(
        [sys.executable, '-c', code, '--config', str(cfg), *SYNTH],
        cwd=REPO, env=_env(), capture_output=True, text=True,
        timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'Data parallel: 2 ranks, gloo backend' in proc.stdout
    # the CPU takes the warp's plain version: no kernel launches
    assert 'Warp kernel launches per rank: [0, 0]' in proc.stdout
    run = tmp_path / 'runs' / 'run'
    assert _history(run) == cli_runs['two_history']
    result = json.loads([line for line in proc.stdout.splitlines()
                         if line.startswith('RESULT ')][-1][7:])
    assert result['save_dir'] == str(run)
    assert result['warp_launches'] == [0, 0]
    assert result['train_loss'] == cli_runs['two_history']['train_loss']
