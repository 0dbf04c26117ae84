"""Segmentation losses on NCHW logits.

Counterpart of ``unet_tpu/train/losses.py`` (the reference loss suite):
soft Dice, (class-weighted) cross entropy, per-image class-balanced CE,
DiceBCE with its binary fast path, and the deep-supervision wrapper with
weights (1.0, 0.4, 0.2, 0.1). Logits are float (N, C, H, W), targets
integer (N, H, W) of any integer dtype; each loss returns a scalar
tensor.

Every loss takes ``sample_weights`` (N,): weight-0 rows contribute
nothing, and each loss keeps its own normalization (per batch for Dice
and balanced CE, per pixel-weight sum for weighted CE).

A loss that divides by a sum over the batch's rows (the class-weighted
CE's pixel-weight sum, or the sum of ``sample_weights``) takes
``den_reduce``: a caller that holds only some rows of the batch (a rank
of a process group) passes the map from its rows' sum to the mean of
that sum over the holders (``trainer.rank_mean``), so the holders' mean
of their losses, which it takes, is the whole batch's loss. The losses
themselves never reduce over ranks.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

DS_WEIGHTS = (1.0, 0.4, 0.2, 0.1)


def _one_hot(targets: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(N, H, W) -> (N, C, H, W) float32; out-of-range labels give a
    zero vector, as ``jax.nn.one_hot`` does."""
    classes = torch.arange(num_classes, device=targets.device)
    return (targets.long()[:, None] == classes[None, :, None, None]).float()


DenReduce = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _ratio(num: torch.Tensor, den: torch.Tensor,
           den_reduce: DenReduce = None) -> torch.Tensor:
    """``num / den``, where ``den`` is a sum over the batch's rows, first
    passed through ``den_reduce`` (see the module docstring)."""
    if den_reduce is not None:
        den = den_reduce(den)
    return num / torch.clamp(den, min=1e-12)


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits.float(), dim=1)
    return -torch.gather(logp, 1, targets.long()[:, None])[:, 0]


def dice_loss(logits: torch.Tensor, targets: torch.Tensor,
              smooth: float = 1.0, ignore_background: bool = True,
              reduction: str = 'mean',
              sample_weights: Optional[torch.Tensor] = None,
              den_reduce: DenReduce = None) -> torch.Tensor:
    """Soft Dice loss. ``sample_weights`` applies to the 'mean'
    reduction (a weighted mean over samples of the per-sample class-mean
    Dice)."""
    num_classes = logits.shape[1]
    probs = torch.softmax(logits.float(), dim=1)
    one_hot = _one_hot(targets, num_classes)
    intersection = torch.sum(probs * one_hot, dim=(2, 3))        # (N, C)
    union = torch.sum(probs, dim=(2, 3)) + torch.sum(one_hot, dim=(2, 3))
    dice = (2.0 * intersection + smooth) / (union + smooth)
    if ignore_background and num_classes > 1:
        dice = dice[:, 1:]
    if reduction == 'mean':
        if sample_weights is None:
            return 1.0 - torch.mean(dice)
        w = sample_weights.float()
        return 1.0 - _ratio(torch.sum(torch.mean(dice, dim=1) * w),
                            torch.sum(w), den_reduce)
    if reduction == 'sum':
        return torch.sum(1.0 - dice)
    return 1.0 - dice


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       class_weights: Optional[Sequence[float]] = None,
                       sample_weights: Optional[torch.Tensor] = None,
                       den_reduce: DenReduce = None) -> torch.Tensor:
    """(Optionally class-weighted) CE with ``nn.CrossEntropyLoss``'s
    normalization: with class weights the mean divides by the sum of the
    per-pixel weights."""
    nll = _nll(logits, targets)
    if class_weights is None:
        if sample_weights is None:
            return torch.mean(nll)
        sw = sample_weights.float()
        px = nll.shape[1] * nll.shape[2]
        return _ratio(torch.sum(nll * sw[:, None, None]),
                      torch.sum(sw) * px, den_reduce)
    cw = torch.as_tensor(class_weights, dtype=torch.float32,
                         device=logits.device)
    w = cw[targets.long()]
    if sample_weights is not None:
        w = w * sample_weights.float()[:, None, None]
    return _ratio(torch.sum(nll * w), torch.sum(w), den_reduce)


def balanced_ce_loss(logits: torch.Tensor, targets: torch.Tensor,
                     class_weight: float = 0.5, smooth: float = 1e-6,
                     sample_weights: Optional[torch.Tensor] = None,
                     den_reduce: DenReduce = None) -> torch.Tensor:
    """Per-image class-balanced CE: a class-1 pixel weighs
    class_weight / (#class-1 px + smooth), a class-0 pixel
    (1 - class_weight) / (#class-0 px + smooth); the sum divides by N.
    Binary by construction."""
    ce = _nll(logits, targets)
    tumor = (targets == 1).float()
    bg = (targets == 0).float()
    n_tumor = torch.sum(tumor, dim=(1, 2)) + smooth
    n_bg = torch.sum(bg, dim=(1, 2)) + smooth
    w = (tumor * (class_weight / n_tumor)[:, None, None]
         + bg * ((1.0 - class_weight) / n_bg)[:, None, None])
    if sample_weights is None:
        return torch.sum(ce * w) / logits.shape[0]
    sw = sample_weights.float()
    return _ratio(torch.sum(ce * w * sw[:, None, None]), torch.sum(sw),
                  den_reduce)


def _dice_bce_binary_fast(logits: torch.Tensor, targets: torch.Tensor,
                          ce_weight: float, dice_weight: float,
                          class_weight: float, dice_smooth: float = 1.0,
                          bce_smooth: float = 1e-6,
                          sample_weights: Optional[torch.Tensor] = None,
                          den_reduce: DenReduce = None) -> torch.Tensor:
    """Binary DiceBCE from the logit margin d = l1 - l0 alone, equal to
    balanced CE + Dice (ignore background) with about half the
    full-resolution passes: p1 = sigmoid(d); CE = softplus(-d) on tumor
    pixels, softplus(d) on background."""
    d = (logits[:, 1] - logits[:, 0]).float()
    t = targets == 1
    tf = t.float()
    p1 = torch.sigmoid(d)
    inter = torch.sum(p1 * tf, dim=(1, 2))
    union = torch.sum(p1, dim=(1, 2)) + torch.sum(tf, dim=(1, 2))
    dice = (2.0 * inter + dice_smooth) / (union + dice_smooth)
    ce = torch.where(t, F.softplus(-d), F.softplus(d))
    n_tumor = torch.sum(tf, dim=(1, 2)) + bce_smooth
    n_bg = torch.sum(1.0 - tf, dim=(1, 2)) + bce_smooth
    w = torch.where(t, (class_weight / n_tumor)[:, None, None],
                    ((1.0 - class_weight) / n_bg)[:, None, None])
    if sample_weights is None:
        dice_term = 1.0 - torch.mean(dice)
        ce_term = torch.sum(ce * w) / logits.shape[0]
    else:
        sw = sample_weights.float()
        den = torch.sum(sw) if den_reduce is None else den_reduce(
            torch.sum(sw))
        dice_term = 1.0 - _ratio(torch.sum(dice * sw), den)
        ce_term = _ratio(torch.sum(ce * w * sw[:, None, None]), den)
    return ce_weight * ce_term + dice_weight * dice_term


def dice_bce_loss(logits: torch.Tensor, targets: torch.Tensor,
                  ce_weight: float = 1.0, dice_weight: float = 1.0,
                  class_weight: float = 0.5,
                  sample_weights: Optional[torch.Tensor] = None,
                  den_reduce: DenReduce = None) -> torch.Tensor:
    """Balanced CE + Dice; two classes take the margin fast path."""
    kw = dict(sample_weights=sample_weights, den_reduce=den_reduce)
    if logits.shape[1] == 2:
        return _dice_bce_binary_fast(logits, targets, ce_weight,
                                     dice_weight, class_weight, **kw)
    return (ce_weight * balanced_ce_loss(logits, targets, class_weight,
                                         **kw)
            + dice_weight * dice_loss(logits, targets,
                                      ignore_background=True, **kw))


def deep_supervision_loss(base_loss: Callable[..., torch.Tensor],
                          predictions, targets: torch.Tensor,
                          weights: Sequence[float] = DS_WEIGHTS,
                          sample_weights: Optional[torch.Tensor] = None,
                          den_reduce: DenReduce = None) -> torch.Tensor:
    """Weighted sum over (main, ds1, ds2, ds3); a single tensor passes
    through."""
    kw = dict(sample_weights=sample_weights, den_reduce=den_reduce)
    if isinstance(predictions, (list, tuple)):
        total = 0.0
        for pred, w in zip(predictions, weights):
            total = total + w * base_loss(pred, targets, **kw)
        return total
    return base_loss(predictions, targets, **kw)


def create_loss_function(loss_type: str = 'dice_bce', ce_weight: float = 1.0,
                         dice_weight: float = 1.0,
                         class_weights: Optional[Sequence[float]] = None,
                         balanced_class_weight: float = 0.5,
                         **_: object) -> Callable:
    """Loss factory ('dice' | 'ce'/'crossentropy' | 'balanced_ce' |
    'dice_bce'). Returns fn(predictions, targets, sample_weights=None,
    den_reduce=None). A tuple of predictions (a deep-supervision model in
    training) always takes the weighted sum, so the JAX factory's
    ``deep_supervision`` keyword, accepted and ignored here, selects
    nothing."""
    loss_type = loss_type.lower()
    if loss_type == 'dice':
        base = lambda p, t, **kw: dice_loss(p, t, ignore_background=True,
                                            **kw)
    elif loss_type in ('ce', 'crossentropy'):
        base = lambda p, t, **kw: cross_entropy_loss(p, t, class_weights,
                                                     **kw)
    elif loss_type == 'balanced_ce':
        base = lambda p, t, **kw: balanced_ce_loss(
            p, t, balanced_class_weight, **kw)
    elif loss_type == 'dice_bce':
        base = lambda p, t, **kw: dice_bce_loss(
            p, t, ce_weight, dice_weight, balanced_class_weight, **kw)
    else:
        raise ValueError(f'Unknown loss type: {loss_type}')
    return lambda p, t, sample_weights=None, den_reduce=None: (
        deep_supervision_loss(base, p, t, sample_weights=sample_weights,
                              den_reduce=den_reduce))
