"""The port's training path (train-mode models and the train step,
unet_tpu_torch/models and unet_tpu_torch/train/trainer.py) against the
JAX package in float32, from the same weights carried by
state_dict_from_jax: params, BatchNorm statistics and AdamW moments.

Tolerances, each from the arithmetic compared:
* BatchNorm alone: rtol 1e-5 (the same float32 reductions in another
  order).
* Whole-model train forward, updated statistics and gradients: the two
  frameworks' convolutions sum in other orders, and the differences
  (~1e-6 relative per conv) compound over the 23-conv stack and the
  backward pass; held to 1e-3 of each tensor's largest magnitude, where
  a wiring error is O(1) of it.
* Parameters after N AdamW steps: at step t, m_hat/sqrt(v_hat) turns
  float32 noise in a near-zero gradient into up to +-lr of movement, so
  parameters are held to 2*lr*N absolute (lr 1e-3, N 2), while the
  gradients above are held tightly.
* AdamW moments after the first step from the carried state (same
  params on both sides): 5e-3 of the largest moment of the model (the
  step's gradients carry the 1e-3 above, and v takes 2*g*dg of it;
  measured 1.8e-3). They
  are not compared after the second step: this base-4 model with
  train-mode BatchNorm over 2 x 2 x 2 bottleneck values is so
  ill-conditioned that a 4e-6 random change of the parameters moves
  some gradients by 2.5% of the largest one (measured), and the two
  sides' parameters differ by that much after one step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unet_tpu.models import create_model as jax_create_model
from unet_tpu.models.layers import TorchBatchNorm as FlaxBN
from unet_tpu.train import losses as jl
from unet_tpu.train import trainer as jt
from unet_tpu_torch.models import create_model
from unet_tpu_torch.models.layers import TorchBatchNorm
from unet_tpu_torch.train import losses as tl
from unet_tpu_torch.train import trainer as tt
from unet_tpu_torch.utils.torch_port import state_dict_from_jax
from torch_port_helpers import jax_variables, load_adam_state

torch.set_num_threads(2)

HW, BASE, B = 32, 4, 2
LR = 1e-3


def _close(got, want, rel=1e-3, what=''):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-12)
    err = np.abs(got - want).max()
    assert err <= rel * scale, f'{what}: max err {err:.3g} vs scale {scale:.3g}'


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _batch(seed, lead=(B,)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*lead, HW, HW, 1)).astype(np.float32)
    yy, xx = np.mgrid[0:HW, 0:HW]
    m = np.zeros((*lead, HW, HW), np.int32)
    flat = m.reshape(-1, HW, HW)
    for i in range(flat.shape[0]):
        cy, cx = rng.uniform(8, 24, 2)
        flat[i] = (yy - cy) ** 2 + (xx - cx) ** 2 < rng.uniform(9, 36)
    return x, m


def _models(model_type='attention_unet', bilinear=True, ds=True, seed=0):
    kw = dict(bilinear=bilinear, base_features=BASE)
    if model_type == 'attention_unet':
        kw['deep_supervision'] = ds
    jm = jax_create_model(model_type, **kw)
    variables = jax_variables(jm, seed)
    model = create_model(model_type, **kw)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jm, variables, model


def _bn_stats(model):
    return {k: v for k, v in model.state_dict().items()
            if k.endswith(('running_mean', 'running_var'))}


# ---------------------------------------------------------------- BatchNorm

@pytest.mark.parametrize('shape', [(4, 6, 5, 3), (1, 1, 1, 2)])
def test_train_batchnorm_matches_flax(shape):
    """Biased variance to normalize, unbiased (n/(n-1)) into the running
    variance, momentum 0.1; a 1-pixel batch takes the max(n-1, 1)."""
    rng = np.random.default_rng(0)
    c = shape[-1]
    x = (3 * rng.standard_normal(shape) + 1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    mean = rng.standard_normal(c).astype(np.float32)
    var = rng.uniform(0.5, 2, c).astype(np.float32)
    variables = {'params': {'scale': scale, 'bias': bias},
                 'batch_stats': {'mean': mean, 'var': var}}
    want, upd = FlaxBN(use_running_average=False).apply(
        variables, jnp.asarray(x), mutable=['batch_stats'])
    bn = TorchBatchNorm(c)
    bn.load_state_dict({
        'weight': torch.from_numpy(scale), 'bias': torch.from_numpy(bias),
        'running_mean': torch.from_numpy(mean),
        'running_var': torch.from_numpy(var),
        'num_batches_tracked': torch.tensor(0)})
    bn.train()
    got = bn(_nchw(x)).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(upd['batch_stats']['mean']),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(upd['batch_stats']['var']),
                               rtol=1e-5, atol=1e-6)
    assert int(bn.num_batches_tracked) == 1


def test_train_batchnorm_bf16_keeps_float32_statistics():
    """bf16 input: statistics in float32 and finite, buffers stay f32."""
    bn = TorchBatchNorm(3).train()
    x = (torch.randn(2, 3, 8, 8, generator=torch.Generator().manual_seed(0))
         * 50 + 200).to(torch.bfloat16)
    y = bn(x)
    assert y.dtype == torch.bfloat16 and bn.running_var.dtype == torch.float32
    want = x.float().var(dim=(0, 2, 3), unbiased=True)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               (0.9 + 0.1 * want).numpy(), rtol=1e-3)


# ---------------------------------------------------------------- forward

@pytest.mark.parametrize('model_type,bilinear,ds', [
    ('attention_unet', True, True),
    ('attention_unet', False, False),
    ('unet', True, False),
])
def test_train_forward_and_batch_stats_match_flax(model_type, bilinear, ds):
    jm, variables, model = _models(model_type, bilinear, ds)
    x, _ = _batch(1)
    outs, upd = jm.apply(variables, jnp.asarray(x), train=True,
                         mutable=['batch_stats'])
    model.train()
    got = model(_nchw(x))
    if ds:
        assert isinstance(got, tuple) and len(got) == 4
        assert all(o.shape == (B, 2, HW, HW) and o.dtype == torch.float32
                   for o in got)
    else:
        got, outs = (got,), (outs,)
    for i, (g, w) in enumerate(zip(got, outs)):
        _close(g.detach().permute(0, 2, 3, 1).numpy(), w, what=f'head {i}')
    want_stats = state_dict_from_jax({'batch_stats': upd['batch_stats']})
    for k, v in _bn_stats(model).items():
        _close(v.numpy(), want_stats[k].numpy(), what=k)
    model.eval()
    assert torch.is_tensor(model(_nchw(x)))  # eval returns the logits only


def test_gradients_match_jax_grad():
    """d(DiceBCE with deep supervision)/d(params) for one microbatch;
    the port's float32 parameters get float32 gradients."""
    jm, variables, model = _models()
    x, m = _batch(2)
    jloss = jl.create_loss_function('dice_bce', deep_supervision=True)

    def loss_of(p):
        outs, _ = jm.apply({'params': p,
                            'batch_stats': variables['batch_stats']},
                           jnp.asarray(x), train=True,
                           mutable=['batch_stats'])
        return jloss(outs, jnp.asarray(m))

    want_loss, grads = jax.jit(jax.value_and_grad(loss_of))(
        variables['params'])
    want = state_dict_from_jax({'params': grads})
    model.train()
    loss = tl.create_loss_function('dice_bce', deep_supervision=True)(
        model(_nchw(x)), torch.from_numpy(m))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    for k, p in named.items():
        assert p.grad is not None and p.grad.dtype == torch.float32, k
        _close(p.grad.numpy(), want[k].numpy(), what=k)


def test_bf16_model_gives_float32_gradients():
    model = create_model('attention_unet', base_features=BASE,
                         dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(0)).train()
    x, m = _batch(3)
    tl.dice_bce_loss(model(_nchw(x)), torch.from_numpy(m)).backward()
    for k, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, k
        assert torch.isfinite(p.grad).all(), k


# ---------------------------------------------------------------- the step

def _jax_state(jm, variables, tx):
    params, stats = variables['params'], variables['batch_stats']
    ema = jt.EmaState(params=jax.tree.map(jnp.copy, params),
                      batch_stats=jax.tree.map(jnp.copy, stats),
                      updates=jnp.zeros((), jnp.int32))
    return jt.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                         batch_stats=stats, opt_state=tx.init(params),
                         ema=ema)


@pytest.mark.parametrize('grad_clip', [1e-3, 1e3], ids=['clip_active',
                                                       'clip_inactive'])
def test_train_step_matches_jax(grad_clip):
    """Accumulation 2: one JAX step to give the AdamW moments a history,
    then params, moments, BatchNorm statistics and the EMA carried into
    the port, and two more steps on both sides, the last a leftover flush
    (mb_mask [1, 0])."""
    jm, variables, model = _models(seed=4)
    jloss = jl.create_loss_function('dice_bce', deep_supervision=True)
    tx = jt.create_optimizer(LR, weight_decay=1e-4, grad_clip=grad_clip)
    jstep = jax.jit(jt.make_train_step(jm, jloss, tx, accum_steps=2,
                                       ema_decay=0.9, use_ema=True))
    batches = [_batch(10 + i, lead=(2, B)) for i in range(3)]
    masks = [np.ones(2, np.float32), np.ones(2, np.float32),
             np.asarray([1, 0], np.float32)]

    state = _jax_state(jm, variables, tx)
    state, _ = jstep(state, *map(jnp.asarray, batches[0]), np.float32(LR),
                     masks[0])
    model.load_state_dict(state_dict_from_jax(
        {'params': state.params, 'batch_stats': state.batch_stats}))
    opt = tt.create_optimizer(model, LR, weight_decay=1e-4)
    load_adam_state(opt, model, state.opt_state)
    ema = tt.ema_reinit(model)
    ema.params.update(state_dict_from_jax({'params': state.ema.params}))
    ema.updates = int(state.ema.updates)
    step = tt.make_train_step(
        model, tl.create_loss_function('dice_bce', deep_supervision=True),
        opt, accum_steps=2, ema_decay=0.9, use_ema=True,
        grad_clip=grad_clip)

    for i, ((x, m), mb) in enumerate(zip(batches[1:], masks[1:])):
        stats_before = {k: v.clone() for k, v in _bn_stats(model).items()}
        state, want_loss = jstep(state, jnp.asarray(x), jnp.asarray(m),
                                 np.float32(LR), mb)
        got_loss = step(torch.from_numpy(x).permute(0, 1, 4, 2, 3),
                        torch.from_numpy(m), LR, mb, ema)
        assert got_loss.dim() == 0
        np.testing.assert_allclose(float(got_loss), float(want_loss),
                                   rtol=1e-4)
        want_p = state_dict_from_jax({'params': state.params})
        for k, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want_p[k].numpy(),
                                       rtol=0, atol=2 * LR * 2, err_msg=k)
        want_s = state_dict_from_jax({'batch_stats': state.batch_stats})
        for k, v in _bn_stats(model).items():
            _close(v.numpy(), want_s[k].numpy(), what=k)
        if mb[1] == 0:  # one real microbatch: one BN update per layer
            for k, v in _bn_stats(model).items():
                assert not torch.equal(v, stats_before[k]), k
        if i == 0:
            jadam = state.opt_state.inner_state[1][0]
            for tree, key in ((jadam.mu, 'exp_avg'),
                              (jadam.nu, 'exp_avg_sq')):
                want = state_dict_from_jax({'params': tree})
                scale = max(v.abs().max().item() for v in want.values())
                for k, p in model.named_parameters():
                    np.testing.assert_allclose(
                        opt.state[p][key].numpy(), want[k].numpy(), rtol=0,
                        atol=5e-3 * scale, err_msg=f'{key} {k}')
                    assert float(opt.state[p]['step']) == 2
    assert step.steps == 2
    assert ema.updates == int(state.ema.updates) == 3
    want_e = state_dict_from_jax({'params': state.ema.params})
    for k, v in ema.params.items():
        np.testing.assert_allclose(v.numpy(), want_e[k].numpy(), rtol=0,
                                   atol=2 * LR * 2, err_msg=k)


@pytest.mark.parametrize('max_norm', [0.5, 1e6])
def test_clip_by_global_norm_equals_optax(max_norm):
    rng = np.random.default_rng(5)
    tree = {f'g{i}': rng.standard_normal(s).astype(np.float32)
            for i, s in enumerate([(3, 4), (7,), (2, 2, 2)])}
    clip = optax.clip_by_global_norm(max_norm)
    want, _ = clip.update(jax.tree.map(jnp.asarray, tree),
                          clip.init(tree))
    grads = [torch.from_numpy(v.copy()) for v in tree.values()]
    norm = tt.clip_by_global_norm(grads, max_norm)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(tree)),
                               rtol=1e-6)
    for g, w, orig in zip(grads, want.values(), tree.values()):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
        if max_norm > 1e3:  # inactive: untouched
            assert np.array_equal(g.numpy(), orig)


def test_ema_update_and_reinit_match_jax():
    jm, variables, model = _models(seed=6)
    rng = np.random.default_rng(6)
    shadow = jax.tree.map(lambda a: a + rng.standard_normal(a.shape).astype(
        np.float32), variables['params'])
    for warmup in (0, 5):
        jema = jt.EmaState(params=shadow,
                           batch_stats=jax.tree.map(jnp.zeros_like,
                                                    variables['batch_stats']),
                           updates=jnp.asarray(1, jnp.int32))
        ema = tt.ema_reinit(model)
        ema.params.update(state_dict_from_jax({'params': shadow}))
        ema.updates = 1
        for _ in range(2):
            jema = jt.ema_update(jema, variables['params'],
                                 variables['batch_stats'], 0.99,
                                 warmup_steps=warmup)
            tt.ema_update(ema, model, 0.99, warmup_steps=warmup)
        want = state_dict_from_jax({'params': jema.params,
                                    'batch_stats': jema.batch_stats})
        assert ema.updates == int(jema.updates) == 3
        for k, v in ema.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=k)
    fresh = tt.ema_reinit(model)
    assert fresh.updates == 0
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v)
        assert fresh.state_dict()[k].data_ptr() != v.data_ptr()  # a copy


def test_eval_step_matches_jax_and_weighted_tail():
    jm, variables, model = _models(seed=7)
    x, m = _batch(8, lead=(3,))
    jloss = jl.create_loss_function('dice_bce')
    tloss = tl.create_loss_function('dice_bce')
    w = np.asarray([1, 1, 0], np.float32)
    for with_w in (False, True):
        jstep = jt.make_eval_step(jm, jloss, 2, with_weights=with_w)
        tstep = tt.make_eval_step(model, tloss, 2, with_weights=with_w)
        jargs = (variables['params'], variables['batch_stats'],
                 jnp.asarray(x), jnp.asarray(m))
        targs = (_nchw(x), torch.from_numpy(m))
        if with_w:
            jargs, targs = jargs + (jnp.asarray(w),), targs + (
                torch.from_numpy(w),)
        want_loss, want_cm = jstep(*jargs)
        got_loss, got_cm = tstep(*targs)
        np.testing.assert_allclose(float(got_loss), float(want_loss),
                                   rtol=1e-4)
        # argmax may flip only where the two logits tie within f32 noise
        assert np.abs(got_cm.numpy() - np.asarray(want_cm)).sum() <= 2
        assert got_cm.sum() == (2 if with_w else 3) * HW * HW


def test_group_into_superbatches():
    assert list(tt.group_into_superbatches(10, 4)) == [(0, 4), (4, 4),
                                                       (8, 2)]
    assert list(tt.group_into_superbatches(10, 4)) == list(
        jt.group_into_superbatches(10, 4))
