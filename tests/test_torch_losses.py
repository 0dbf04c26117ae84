"""The port's losses, metrics and schedules (unet_tpu_torch/train/) against
the JAX package's on the same inputs (logits NCHW in the port, NHWC in
JAX).

Tolerances: losses are float32 reductions over the same values summed in
another order, rtol 1e-5. The confusion matrix is integer counting and
must be exact; metrics computed from one matrix must be equal. The
schedules are the same Python float arithmetic and must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_tpu.train import losses as jl
from unet_tpu.train import metrics as jm
from unet_tpu.train import schedules as js
from unet_tpu_torch.train import losses as tl
from unet_tpu_torch.train import metrics as tm
from unet_tpu_torch.train import schedules as ts

torch.set_num_threads(2)

RTOL = 1e-5


def _inputs(seed, n=3, c=2, h=16, w=12, empty_tumor=True):
    rng = np.random.default_rng(seed)
    logits = (2 * rng.standard_normal((n, h, w, c))).astype(np.float32)
    targets = rng.integers(0, c, (n, h, w)).astype(np.int32)
    if empty_tumor:
        targets[0] = 0  # a slice without tumor: the smoothing terms count
    sw = np.asarray([1.0, 0.0, 2.0][:n], np.float32)
    return logits, targets, sw


def _pair(logits, targets, sw):
    jax_args = (jnp.asarray(logits), jnp.asarray(targets))
    port_args = (torch.from_numpy(logits).permute(0, 3, 1, 2),
                 torch.from_numpy(targets))
    return jax_args, port_args, jnp.asarray(sw), torch.from_numpy(sw)


LOSSES = {
    'dice': (jl.dice_loss, tl.dice_loss, {}),
    'dice_keep_bg': (jl.dice_loss, tl.dice_loss,
                     {'ignore_background': False}),
    'ce': (jl.cross_entropy_loss, tl.cross_entropy_loss, {}),
    'ce_class_weights': (jl.cross_entropy_loss, tl.cross_entropy_loss,
                         {'class_weights': [0.3, 1.7]}),
    'balanced_ce': (jl.balanced_ce_loss, tl.balanced_ce_loss,
                    {'class_weight': 0.7}),
    'dice_bce': (jl.dice_bce_loss, tl.dice_bce_loss,
                 {'ce_weight': 0.6, 'dice_weight': 1.3,
                  'class_weight': 0.4}),
}


@pytest.mark.parametrize('weighted', [False, True])
@pytest.mark.parametrize('name', list(LOSSES))
def test_loss_matches_jax(name, weighted):
    jfn, tfn, kw = LOSSES[name]
    ja, pa, jsw, tsw = _pair(*_inputs(1))
    jkw = {**kw, 'sample_weights': jsw} if weighted else kw
    tkw = {**kw, 'sample_weights': tsw} if weighted else kw
    np.testing.assert_allclose(float(tfn(*pa, **tkw)),
                               float(jfn(*ja, **jkw)), rtol=RTOL)


@pytest.mark.parametrize('reduction', ['sum', 'none'])
def test_dice_reductions_match_jax(reduction):
    ja, pa, _, _ = _pair(*_inputs(2))
    want = np.asarray(jl.dice_loss(*ja, reduction=reduction))
    got = tl.dice_loss(*pa, reduction=reduction).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_multiclass_dice_bce_matches_jax():
    """Three classes take the general path (balanced CE + Dice)."""
    ja, pa, jsw, tsw = _pair(*_inputs(3, c=3))
    np.testing.assert_allclose(float(tl.dice_bce_loss(*pa)),
                               float(jl.dice_bce_loss(*ja)), rtol=RTOL)
    np.testing.assert_allclose(
        float(tl.dice_bce_loss(*pa, sample_weights=tsw)),
        float(jl.dice_bce_loss(*ja, sample_weights=jsw)), rtol=RTOL)


@pytest.mark.parametrize('weighted', [False, True])
def test_binary_fast_path_equals_general_path(weighted):
    _, (logits, targets), _, sw = _pair(*_inputs(4))
    kw = {'sample_weights': sw} if weighted else {}
    fast = tl.dice_bce_loss(logits, targets, 0.6, 1.3, 0.4, **kw)
    general = (0.6 * tl.balanced_ce_loss(logits, targets, 0.4, **kw)
               + 1.3 * tl.dice_loss(logits, targets, **kw))
    np.testing.assert_allclose(float(fast), float(general), rtol=RTOL)


@pytest.mark.parametrize('deep_supervision', [False, True])
@pytest.mark.parametrize('loss_type', ['dice', 'ce', 'balanced_ce',
                                       'dice_bce'])
def test_create_loss_function_and_deep_supervision(loss_type,
                                                   deep_supervision):
    """The factory's loss on one head and on a (main, ds1, ds2, ds3)
    tuple (weights 1.0, 0.4, 0.2, 0.1), with and without weights."""
    kw = dict(loss_type=loss_type, ce_weight=0.8, dice_weight=1.2,
              balanced_class_weight=0.6, deep_supervision=deep_supervision)
    jfn, tfn = jl.create_loss_function(**kw), tl.create_loss_function(**kw)
    heads = [_pair(*_inputs(10 + i)) for i in range(4)]
    ja = tuple(h[0][0] for h in heads)
    pa = tuple(h[1][0] for h in heads)
    jt, tt = heads[0][0][1], heads[0][1][1]
    jsw, tsw = heads[0][2], heads[0][3]
    for j_pred, t_pred in ((ja[0], pa[0]), (ja, pa)):
        np.testing.assert_allclose(float(tfn(t_pred, tt)),
                                   float(jfn(j_pred, jt)), rtol=RTOL)
        np.testing.assert_allclose(
            float(tfn(t_pred, tt, sample_weights=tsw)),
            float(jfn(j_pred, jt, sample_weights=jsw)), rtol=RTOL)


def test_unknown_loss_type_raises():
    with pytest.raises(ValueError, match='Unknown loss'):
        tl.create_loss_function('focal')


def test_loss_gradient_matches_jax():
    """d(DiceBCE)/d(logits) through the fast path."""
    import jax
    (ja, pa, _, _) = _pair(*_inputs(5))
    want = np.asarray(jax.grad(lambda l: jl.dice_bce_loss(l, ja[1]))(ja[0]))
    logits = pa[0].clone().requires_grad_(True)
    tl.dice_bce_loss(logits, pa[1]).backward()
    got = logits.grad.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-6 * np.abs(want).max())


# ---------------------------------------------------------------- metrics

@pytest.mark.parametrize('as_logits', [False, True])
def test_confusion_matrix_is_exact(as_logits):
    """Out-of-range labels (-1, 2, 7) and predictions are dropped."""
    rng = np.random.default_rng(6)
    n, h, w, c = 3, 20, 16, 2
    targets = rng.integers(-1, 3, (n, h, w)).astype(np.int32)
    targets[0, :2] = 7
    if as_logits:
        preds = rng.standard_normal((n, h, w, c)).astype(np.float32)
        port_preds = torch.from_numpy(preds).permute(0, 3, 1, 2)
    else:
        preds = rng.integers(0, 3, (n, h, w)).astype(np.int32)
        port_preds = torch.from_numpy(preds)
    want = np.asarray(jm.confusion_matrix_update(
        jnp.asarray(preds), jnp.asarray(targets), c))
    got = tm.confusion_matrix_update(port_preds, torch.from_numpy(targets), c)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.sum() < n * h * w  # something was dropped


def test_confusion_matrix_ignore_index():
    rng = np.random.default_rng(7)
    preds = rng.integers(0, 3, (2, 8, 8)).astype(np.int32)
    targets = rng.integers(0, 3, (2, 8, 8)).astype(np.int32)
    want = np.asarray(jm.confusion_matrix_update(
        jnp.asarray(preds), jnp.asarray(targets), 3, ignore_index=2))
    got = tm.confusion_matrix_update(torch.from_numpy(preds),
                                     torch.from_numpy(targets), 3,
                                     ignore_index=2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('cm', [
    [[50, 3], [4, 9]],
    [[60, 0], [0, 0]],        # no tumor anywhere: tumor metrics are 0
    [[0, 0], [0, 0]],         # empty
    [[10, 2, 0], [1, 7, 3], [0, 0, 5]],
])
def test_metrics_from_confusion_equal_jax(cm):
    cm = np.asarray(cm, np.int64)
    assert tm.metrics_from_confusion(cm) == jm.metrics_from_confusion(cm)


def test_segmentation_metrics_accumulate_like_jax():
    rng = np.random.default_rng(8)
    names = ['background', 'tumor']
    jmet, tmet = jm.SegmentationMetrics(2, names), tm.SegmentationMetrics(
        2, names)
    for _ in range(3):
        logits = rng.standard_normal((2, 8, 8, 2)).astype(np.float32)
        targets = rng.integers(0, 2, (2, 8, 8)).astype(np.int32)
        jmet.update(logits, targets)
        tmet.update(torch.from_numpy(logits).permute(0, 3, 1, 2),
                    torch.from_numpy(targets))
    tmet.update_from_matrix(torch.tensor([[1, 2], [3, 4]]))
    jmet.update_from_matrix(np.asarray([[1, 2], [3, 4]]))
    assert tmet.compute() == jmet.compute()
    np.testing.assert_array_equal(tmet.get_confusion_matrix(),
                                  jmet.get_confusion_matrix())
    tmet.reset()
    assert tmet.get_confusion_matrix().sum() == 0


# ---------------------------------------------------------------- schedules

@pytest.mark.parametrize('cfg', [
    {'type': 'warmup_cosine', 'warmup_epochs': 10, 'warmup_lr': 1e-6},
    {'type': 'warmup_cosine', 'warmup_epochs': 3},
    {'type': 'cosine_annealing', 'min_lr': 1e-6},
])
def test_epoch_schedules_equal_jax(cfg):
    epochs = 150
    kind_j, fj = js.create_scheduler(cfg, 5e-5, epochs)
    kind_t, ft = ts.create_scheduler(cfg, 5e-5, epochs)
    assert kind_j == kind_t == 'epoch'
    assert [ft(e) for e in range(epochs)] == [fj(e) for e in range(epochs)]
    if cfg['type'] == 'warmup_cosine':
        assert ft(epochs - 1) < 1e-7  # decays toward 0, not min_lr


def test_reduce_on_plateau_equals_jax():
    cfg = {'type': 'reduce_on_plateau', 'factor': 0.5, 'patience': 2,
           'min_lr': 1e-5}
    _, pj = js.create_scheduler(cfg, 1e-3, 100)
    _, pt = ts.create_scheduler(cfg, 1e-3, 100)
    rng = np.random.default_rng(9)
    metrics = list(np.cumsum(rng.uniform(-0.01, 0.02, 60)) + 0.5)
    # a plateau just inside and just outside the relative threshold
    metrics += [metrics[-1] * (1 + 0.5e-4)] * 5 + [metrics[-1] * 1.01] * 5
    for m in metrics:
        assert pt.step(m) == pj.step(m)
        assert pt.lr == pj.lr
    assert pt.state_dict() == pj.state_dict()
    assert pt.num_reductions > 0
