"""Train-mode BatchNorm (+ReLU) as one autograd Function of two passes
each way (``unet_tpu_torch/ops/batch_norm.py``; kernels in
``unet_tpu_torch/csrc/batch_norm.cu``).

On the CPU the plain passes (``PlainPasses``) are held, in float64, against
autograd through the eager ``TorchBatchNorm`` that CPU tensors keep (whose
statistics are float32):
output, input and parameter gradients, running statistics and the update
count, at C = 1 (the attention gate's psi), 32 and 64, with and without
the ReLU; and the process-group form (per-channel sums all-reduced
between the passes) on two gloo ranks against one process.

Tests marked ``chip`` need the card and skip elsewhere. This file imports
no JAX, so they run on the card's machine, which has none, without
``tests/conftest.py``:

    python -m pytest tests/test_torch_batch_norm.py --noconftest -m chip
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from unet_tpu_torch.models.layers import (AttentionGate, DoubleConv,
                                          TorchBatchNorm)
from unet_tpu_torch.ops import batch_norm as bn_ops
from unet_tpu_torch.ops._build import launches
from unet_tpu_torch.ops.batch_norm import (BatchNormTrain, PlainPasses,
                                           batch_norm_train,
                                           check_kernel_args)

REPO = Path(__file__).resolve().parent.parent
CL = torch.channels_last
EPS, KEEP = 1e-5, 0.9
CASES = [(c, relu) for c in (1, 32, 64) for relu in (False, True)]
IDS = [f'C{c}-{"relu" if relu else "plain"}' for c, relu in CASES]
# float64 on both sides: the closed form and autograd through
# E[x^2] - mean^2 agree to rounding
F64 = dict(rtol=1e-9, atol=1e-10)
# against the eager module: it forms mean and E[x^2] in float32 whatever
# the input's dtype (as the JAX package does), so its statistics, and
# what flows from them, carry float32 rounding (the largest gaps seen:
# 8.5e-7 in y, 2.1e-6 in dweight, whose values reach ~10)
EAGER = dict(rtol=1e-5, atol=1e-5)


def _case(c, seed, n=4, h=5, w=6, dtype=torch.float64, device='cpu'):
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float64)

    return dict(
        x=(3 * rnd(n, c, h, w) + 1).to(dtype).to(device).contiguous(
            memory_format=CL),
        dy=rnd(n, c, h, w).to(dtype).to(device).contiguous(memory_format=CL),
        weight=(rnd(c).abs() + 0.5).to(device),
        bias=rnd(c).to(device),
        running_mean=rnd(c).to(device),
        running_var=(rnd(c).abs() + 0.5).to(device))


def _module(case, relu):
    c = case['x'].shape[1]
    bn = TorchBatchNorm(c, relu=relu).to(case['weight'].dtype)
    bn.load_state_dict({k: case[k] for k in ('weight', 'bias',
                                             'running_mean', 'running_var')}
                       | {'num_batches_tracked': torch.tensor(0)})
    return bn.to(case['x'].device).train()


def _eager(case, relu):
    """Autograd through the module's eager path (a CPU tensor)."""
    bn = _module(case, relu)
    x = case['x'].clone().requires_grad_(True)
    y = bn(x)
    (y * case['dy']).sum().backward()
    return dict(y=y.detach(), dx=x.grad, dweight=bn.weight.grad,
                dbias=bn.bias.grad, running_mean=bn.running_mean,
                running_var=bn.running_var, tracked=bn.num_batches_tracked)


def _fused(case, relu, plain=True):
    """The Function on ``case``: the plain passes, or (``plain`` false,
    CUDA tensors) the kernels through ``batch_norm_train``."""
    x = case['x'].clone().requires_grad_(True)
    weight = case['weight'].float() if x.is_cuda else case['weight']
    bias = case['bias'].float() if x.is_cuda else case['bias']
    weight = weight.clone().requires_grad_(True)
    bias = bias.clone().requires_grad_(True)
    rm = case['running_mean'].to(weight.dtype).clone()
    rv = case['running_var'].to(weight.dtype).clone()
    tracked = torch.zeros((), dtype=torch.int64, device=x.device)
    if plain:
        y = BatchNormTrain.apply(x, weight, bias,
                                 (rm, rv, tracked, EPS, KEEP), relu,
                                 PlainPasses)
    else:
        y = batch_norm_train(x, weight, bias, rm, rv, tracked, EPS, KEEP,
                             relu)
    (y * case['dy']).sum().backward()
    return dict(y=y.detach(), dx=x.grad, dweight=weight.grad,
                dbias=bias.grad, running_mean=rm, running_var=rv,
                tracked=tracked)


@pytest.mark.parametrize('c,relu', CASES, ids=IDS)
def test_plain_passes_match_autograd_through_the_module(c, relu):
    case = _case(c, seed=c + relu)
    want, got = _eager(case, relu), _fused(case, relu)
    for k in ('y', 'dx', 'dweight', 'dbias', 'running_mean', 'running_var'):
        torch.testing.assert_close(got[k], want[k], **EAGER, msg=k)
    assert int(got['tracked']) == int(want['tracked']) == 1
    assert got['y'].is_contiguous(memory_format=CL)
    assert got['dx'].is_contiguous(memory_format=CL)


@pytest.mark.parametrize('c', [1, 32, 64])
def test_running_statistics_and_count_follow_the_module(c):
    """Three calls on three batches: the running statistics after each
    and the count, as the eager module moves them."""
    bn = _module(_case(c, seed=0), relu=True)
    rm, rv = bn.running_mean.clone(), bn.running_var.clone()
    tracked = torch.zeros((), dtype=torch.int64)
    w, b = bn.weight.detach().clone(), bn.bias.detach().clone()
    for step in range(3):
        x = _case(c, seed=10 + step, n=3 + step)['x']
        with torch.no_grad():
            bn(x)
            BatchNormTrain.apply(x, w, b, (rm, rv, tracked, EPS, KEEP),
                                 True, PlainPasses)
        torch.testing.assert_close(rm, bn.running_mean, **EAGER)
        torch.testing.assert_close(rv, bn.running_var, **EAGER)
        assert int(tracked) == int(bn.num_batches_tracked) == step + 1


def _run_ranks(tmp, device, world=2):
    from unet_tpu_torch.core.mesh import free_port
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS='2')
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, 'tests/torch_bn_worker.py', f'127.0.0.1:{port}',
         str(r), str(world), str(tmp), device], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return [torch.load(tmp / f'rank{r}.pt') for r in range(world)]


def _rank_cases(dtype=torch.float64, **kw):
    return [dict(_case(c, seed=100 + c + relu, dtype=dtype, **kw), relu=relu)
            for c, relu in CASES]


def _hold_ranks(cases, ranks, one, tol, held=None):
    """Ranks' rows against one process over the whole batch: the output
    and dx row for row (where ``held``, with dweight and dbias given the
    room of ``_flip_room`` elsewhere), dweight and dbias summed over the
    ranks (each rank holds its rows' gradient), the global batch's
    statistics and one update on every rank."""
    for i, (case, want) in enumerate(zip(cases, one)):
        got = [r[i] for r in ranks]
        cat = {k: torch.cat([g[k] for g in got]) for k in ('y', 'dx')}
        room = (None if held is None
                else _flip_room({k: v.cpu() for k, v in case.items()
                                 if torch.is_tensor(v)}, ~held[i]))
        for k in ('y', 'dx'):
            if room is None:
                torch.testing.assert_close(cat[k], want[k].cpu(), **tol,
                                           msg=k)
                continue
            a, b = cat[k][held[i]], want[k].cpu()[held[i]]
            extra = room['dx'][held[i]].float() if k == 'dx' else 0.0
            err = (a - b).abs()
            assert not (err > tol['atol'] + tol['rtol'] * b.abs()
                        + extra).any(), (k, float(err.max()))
        for k in ('dweight', 'dbias'):
            a, b = got[0][k] + got[1][k], want[k].cpu()
            if room is None:
                torch.testing.assert_close(a, b, **tol, msg=k)
            else:
                err = (a - b).abs().double()
                assert not (err > tol['atol'] + tol['rtol'] * b.abs()
                            + room[k]).any(), (k, float(err.max()))
        for g in got:
            for k in ('running_mean', 'running_var'):
                torch.testing.assert_close(g[k], want[k].cpu(), **tol, msg=k)
            assert int(g['tracked']) == 1


@pytest.fixture(scope='module')
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('bn_ranks')
    cases = _rank_cases()
    torch.save(cases, tmp / 'cases.pt')
    return cases, _run_ranks(tmp, 'cpu')


@pytest.mark.parametrize('i', range(len(CASES)), ids=IDS)
def test_process_group_two_passes_equal_one_process(two_ranks, i):
    cases, ranks = two_ranks
    case = cases[i]
    one = _fused(case, case['relu'])
    _hold_ranks([case], [[r[i]] for r in ranks], [one], F64)
    # and the one process agrees with the eager module
    torch.testing.assert_close(one['dx'], _eager(case, case['relu'])['dx'],
                               **EAGER)


def test_cpu_tensor_keeps_the_eager_path(monkeypatch):
    """Training on a CPU tensor runs the module's own code, never the
    Function; its ReLU is the module's old separate ReLU."""
    import unet_tpu_torch.models.layers as layers

    def refuse(*a, **k):
        raise AssertionError('a CPU tensor reached batch_norm_train')

    monkeypatch.setattr(layers, 'batch_norm_train', refuse)
    case = _case(8, seed=3, dtype=torch.float32)
    plain = _module(case, relu=False).float()
    fused = _module(case, relu=True).float()
    y = fused(case['x'])
    torch.testing.assert_close(y, torch.relu(plain(case['x'])), rtol=0,
                               atol=0)
    assert int(fused.num_batches_tracked) == 1


def test_state_dict_keys_unchanged():
    """The reference's names: DoubleConv's BatchNorms at indices 1 and 4
    (the ReLUs inside them leave 2 and 5 without state), the gate's at
    W_g.1, W_x.1, psi.1."""
    bn = ['weight', 'bias', 'running_mean', 'running_var',
          'num_batches_tracked']
    want = (['double_conv.0.weight'] + [f'double_conv.1.{k}' for k in bn]
            + ['double_conv.3.weight'] + [f'double_conv.4.{k}' for k in bn])
    dc = DoubleConv(3, 8)
    assert list(dc.state_dict()) == want
    assert [dc.double_conv[i].relu for i in (1, 4)] == [True, True]
    gate = AttentionGate(16, 16, 8)
    assert list(gate.state_dict()) == [
        f'{m}.{k}' for m in ('W_g', 'W_x', 'psi')
        for k in ['0.weight'] + [f'1.{b}' for b in bn]]
    assert not any(m.relu for m in gate.modules()
                   if isinstance(m, TorchBatchNorm))


@pytest.mark.parametrize('what', ['float16', 'float64', 'nchw', '3d',
                                  'cpu'])
def test_kernels_refuse_other_dtypes_layouts_and_devices(what):
    x = torch.randn(2, 8, 4, 4).contiguous(memory_format=CL)
    if what in ('float16', 'float64'):
        x = x.to(getattr(torch, what))
    elif what == 'nchw':
        x = torch.randn(2, 8, 4, 4)
    elif what == '3d':
        x = torch.randn(8, 4, 4)
    vec = torch.zeros(8)
    error = TypeError if what.startswith('float') else ValueError
    with pytest.raises(error):
        check_kernel_args(x, vec, vec, vec, vec, torch.tensor(0))


# ------------------------------------------------------------ on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _model(kind, dtype=torch.bfloat16):
    from unet_tpu_torch.models import create_model
    model = create_model(kind, base_features=64, dtype=dtype,
                         generator=torch.Generator().manual_seed(0))
    return model.to('cuda', memory_format=CL).train()


def _model_shapes(kind, batch=4, img=512):
    """(C, H, W, relu) of every train-mode BatchNorm call of one forward
    of ``kind`` at ``batch`` x ``img``^2."""
    model = _model(kind)
    shapes, hooks = [], []
    for m in model.modules():
        if isinstance(m, TorchBatchNorm):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, inp: shapes.append(
                    (*inp[0].shape[1:], mod.relu))))
    x = torch.randn(batch, 1, img, img, device='cuda').to(
        torch.bfloat16).contiguous(memory_format=CL)
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    return shapes


def _undecided(case, relu):
    """Where the ReLU's mask is not decided by the statistics: the
    pre-activation (float64, from the batch's own statistics) within
    1e-5 of 0. The kernels' and the plain passes' mean and rstd differ by
    float32 rounding (the sums' order), and the kernels form the
    pre-activation with one FMA where the plain passes round twice; that
    moves a pre-activation by up to ~1e-6 and can flip the mask there,
    and with it that dx element by the whole of its value."""
    x = case['x'].double()
    if not relu:
        return torch.zeros_like(x, dtype=torch.bool)
    mean = x.mean((0, 2, 3), keepdim=True)
    var = x.var((0, 2, 3), unbiased=False, keepdim=True)
    pre = ((x - mean) * torch.rsqrt(var + EPS)
           * case['weight'].view(1, -1, 1, 1)
           + case['bias'].view(1, -1, 1, 1))
    return pre.abs() < 1e-5


def _flip_room(case, undecided):
    """What flipping the mask at the undecided elements can move: per
    channel, dbias by sum |dy| there and dweight by sum |dy * xhat|
    there; and through those sums every dx element, by
    |weight * rstd| * (room of dbias + |xhat| * room of dweight) / n."""
    x = case['x'].double()
    dy = case['dy'].double().abs() * undecided
    rstd = torch.rsqrt(x.var((0, 2, 3), unbiased=False, keepdim=True) + EPS)
    xhat = (x - x.mean((0, 2, 3), keepdim=True)) * rstd
    room = {'dbias': dy.sum((0, 2, 3)),
            'dweight': (dy * xhat.abs()).sum((0, 2, 3))}
    mul = (case['weight'].double().view(1, -1, 1, 1) * rstd).abs()
    n = x.numel() // x.shape[1]
    room['dx'] = mul * (room['dbias'].view(1, -1, 1, 1)
                        + xhat.abs() * room['dweight'].view(1, -1, 1, 1)) / n
    return room


def _within_bf16(got, want, msg, room=0.0):
    """Equal but for a bf16 step: a reduction's order moves mean and rstd
    by float32 rounding, which can flip the bf16 rounding of a value;
    the second term covers values near zero after cancellation; ``room``
    what flipped masks elsewhere can move."""
    got, want = got.float(), want.float()
    bound = want.abs() * 2.0 ** -7 + 1e-3 * want.abs().max() + room
    bad = (got - want).abs() > bound
    assert not bad.any(), (msg, int(bad.sum()), float(
        (got - want).abs().max()))


@pytest.mark.chip
@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
def test_kernels_match_plain_at_every_model_shape(card, dtype):
    """Every BatchNorm shape of AttentionUNet-64 and UNet-64 at b4 512^2:
    the kernels against the plain passes on the same card tensors."""
    shapes = sorted(set(_model_shapes('attention_unet')
                        + _model_shapes('unet')))
    assert any(s[0] == 1 for s in shapes) and any(s[0] == 512
                                                  for s in shapes)
    _hold_kernels_at(shapes, dtype)


# TransUNet's decoder at b4 512^2: conv_more at 32^2, then two
# conv-BatchNorm-ReLU a block at 64^2 ... 512^2
TRANSUNET_DECODER = [(512, 32, 32, True), (256, 64, 64, True),
                     (128, 128, 128, True), (64, 256, 256, True),
                     (16, 512, 512, True)]


@pytest.mark.chip
@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
def test_kernels_match_plain_at_transunet_decoder_shapes(card, dtype):
    """The same check at every BatchNorm shape of TransUNet R50-ViT-B/16's
    decoder at b4 512^2 (C = 512 down to 16), read from the model."""
    shapes = _model_shapes('transunet_r50_vit_b16')
    assert sorted(set(shapes)) == sorted(TRANSUNET_DECODER)
    assert len(shapes) == 9
    _hold_kernels_at(TRANSUNET_DECODER, dtype)


def _hold_kernels_at(shapes, dtype):
    """The kernels against the plain passes, forward and backward, at each
    (C, H, W, relu) of ``shapes`` with batch 4, on the same card tensors."""
    dt = getattr(torch, dtype)
    for i, (c, h, w, relu) in enumerate(shapes):
        case = _case(c, seed=i, n=4, h=h, w=w, dtype=dt, device='cuda')
        got = _fused(case, relu, plain=False)
        want = _fused(case, relu)
        label = f'C{c} {h}x{w} relu={relu} {dtype}'
        held = ~_undecided(case, relu)
        assert held.float().mean() > 0.999, label
        room = _flip_room(case, ~held)
        for k in ('y', 'dx'):
            a, b = got[k][held], want[k][held]
            extra = room['dx'][held].float() if k == 'dx' else 0.0
            if dt == torch.bfloat16:
                _within_bf16(a, b, f'{label} {k}', extra)
            else:
                # float32 on both sides; only the order of the sums differs
                err = (a - b).abs()
                bad = err > 1e-4 + 1e-4 * b.abs() + extra
                assert not bad.any(), (label, k, int(bad.sum()),
                                       float(err.max()))
        for k in ('dweight', 'dbias'):
            # float32 sums of up to 2^20 terms in two orders, against the
            # largest channel's magnitude, plus what a flipped mask at
            # the undecided elements can move
            scale = float(want[k].abs().max()) + 1.0
            err = (got[k] - want[k]).abs().double()
            bad = err > 1e-4 * scale + room[k]
            assert not bad.any(), (label, k, float(err.max()), scale)
        for k in ('running_mean', 'running_var'):
            torch.testing.assert_close(
                got[k], want[k], rtol=1e-5, atol=1e-5,
                msg=lambda m, k=k: f'{label} {k}: {m}')
        assert int(got['tracked']) == 1
        assert got['y'].is_contiguous(memory_format=CL)
        assert got['dx'].is_contiguous(memory_format=CL)


@pytest.mark.chip
def test_two_gloo_ranks_on_one_card_equal_one_process(card, tmp_path):
    """The kernels inside a two-rank gloo group, both ranks on the card,
    against one process over the whole batch (float32)."""
    cases = _rank_cases(dtype=torch.float32, n=4, h=32, w=48)
    torch.save(cases, tmp_path / 'cases.pt')
    ranks = _run_ranks(tmp_path, 'cuda')
    one = [_fused({k: v.cuda() if torch.is_tensor(v) else v
                   for k, v in case.items()}, case['relu'], plain=False)
           for case in cases]
    held = [~_undecided(case, case['relu']) for case in cases]
    # float32 sums over the ranks' rows in another order than one
    # process's
    _hold_ranks(cases, ranks, one, dict(rtol=1e-5, atol=1e-5), held)


@pytest.mark.chip
@pytest.mark.parametrize('kind', ['attention_unet', 'unet'])
def test_train_step_launches_every_batch_norm(card, kind):
    """One TrainStep (microbatch 2 x accumulation 8): each train-mode
    BatchNorm call launches the kernels once forward and once
    backward."""
    from unet_tpu_torch.train.losses import create_loss_function
    from unet_tpu_torch.train.trainer import (create_optimizer,
                                              make_train_step)
    model = _model(kind)
    layers = sum(isinstance(m, TorchBatchNorm) for m in model.modules())
    accum = 8
    step = make_train_step(model, create_loss_function('dice_bce'),
                           create_optimizer(model, 1e-3), accum_steps=accum)
    imgs = torch.randn(accum, 2, 1, 64, 64, device='cuda')
    msks = (torch.rand(accum, 2, 64, 64, device='cuda') > 0.7).long()
    before = launches['batch_norm']
    step(imgs, msks, 1e-3, [1] * accum)
    torch.cuda.synchronize()
    assert (launches['batch_norm'] - before
            == layers * accum * bn_ops.LAUNCHES_PER_CALL)
    assert {18: 'unet', 30: 'attention_unet'}[layers] == kind
    tracked = {int(m.num_batches_tracked) for m in model.modules()
               if isinstance(m, TorchBatchNorm)}
    assert tracked == {accum}


@pytest.mark.chip
def test_eval_launches_none(card):
    model = _model('attention_unet').eval()
    x = torch.randn(2, 1, 64, 64, device='cuda').to(
        torch.bfloat16).contiguous(memory_format=CL)
    before = launches['batch_norm']
    with torch.no_grad():
        model(x)
    torch.cuda.synchronize()
    assert launches['batch_norm'] == before
