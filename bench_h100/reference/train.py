"""The training job, plainly: per super-batch the augmentation, forward
and backward of each microbatch with train-mode BatchNorm, the balanced
cross entropy plus Dice loss, gradients summed and divided by the
accumulation, clipped to a global norm, and one AdamW step.

``follow`` runs the first steps of a job from the benchmark's own
weights and slices and returns what ``compare`` holds the program to:
each step's summed loss, each leaf's norm of the first gradient as the
optimizer gets it, each leaf's change after the steps (parameters,
and BatchNorm's running statistics), and each step's global gradient
norm before the clip.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from bench_h100.reference import augment, strict_fp32
from bench_h100.reference.model import Net, set_fp8

BETAS = (0.9, 0.999)


def warmup_cosine_lr(base_lr: float, warmup_epochs: int,
                     total_epochs: int, epoch: int,
                     warmup_lr: float = 1e-6) -> float:
    """Linear ramp from warmup_lr to base_lr, then half a cosine to 0."""
    ratio = warmup_lr / base_lr
    if epoch < warmup_epochs:
        return base_lr * (ratio + (1 - ratio) * epoch / warmup_epochs)
    progress = (epoch - warmup_epochs) / (total_epochs - warmup_epochs)
    return base_lr * 0.5 * (1 + math.cos(math.pi * progress))


def dice_bce(logits: torch.Tensor, target: torch.Tensor, ce_weight: float,
             dice_weight: float, class_weight: float) -> torch.Tensor:
    """ce_weight * balanced CE + dice_weight * (1 - Dice of the tumor
    class). Balanced CE: a tumor pixel weighs class_weight / (#tumor +
    1e-6), a background pixel (1 - class_weight) / (#background + 1e-6)
    of its own image; the sum is divided by the batch. Dice: (2 I + 1) /
    (U + 1) per image on softmax probabilities, averaged over the
    batch."""
    t = target.long()
    logp = F.log_softmax(logits, dim=1)
    nll = -torch.gather(logp, 1, t[:, None])[:, 0]
    tumor = (t == 1).float()
    bg = (t == 0).float()
    n_t = tumor.sum((1, 2)) + 1e-6
    n_b = bg.sum((1, 2)) + 1e-6
    w = (tumor * (class_weight / n_t)[:, None, None]
         + bg * ((1 - class_weight) / n_b)[:, None, None])
    ce = (nll * w).sum() / logits.shape[0]
    p1 = torch.softmax(logits, dim=1)[:, 1]
    inter = (p1 * tumor).sum((1, 2))
    union = p1.sum((1, 2)) + tumor.sum((1, 2))
    dice = ((2 * inter + 1.0) / (union + 1.0)).mean()
    return ce_weight * ce + dice_weight * (1 - dice)


def follow(model_cfg: Dict, job: Dict, state: Dict[str, torch.Tensor],
           batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
           aug_seed: int, device, fp8: bool = False,
           half_batch: bool = False) -> Dict:
    """Run ``len(batches)`` optimizer steps of ``job`` (the config's
    train, loss, scheduler and augmentation sections with the batch
    layout) from ``state``. Each batch is (uint8 slices (S, H, W), uint8
    masks (S, H, W)) in the order the super-batch holds them, S =
    accumulation x microbatch. ``fp8`` computes the convolutions in
    float8 (the control); ``half_batch`` plants a fault: each microbatch's
    loss is the mean over its first half of rows alone."""
    strict_fp32()
    net = Net(model_cfg).to(device)
    net.load_state_dict(state)
    set_fp8(net, fp8)
    net.train()
    tr, loss_cfg = job['train'], job['loss']
    lr = warmup_cosine_lr(tr['lr'], job['scheduler']['warmup_epochs'],
                          tr['epochs'], 0)
    opt = torch.optim.AdamW(net.parameters(), lr=lr, betas=BETAS, eps=1e-8,
                            weight_decay=tr['weight_decay'], foreach=False)
    accum, micro = job['accumulation_steps'], job['batch_size']
    aug_on = job['augmentation'].get('enabled', True)
    init = {k: v.detach().clone() for k, v in net.state_dict().items()}
    out: Dict = {'loss': [], 'grad_norm': []}
    for step, (u8, masks) in enumerate(batches):
        if aug_on:
            x, m = augment.augment(u8, masks, job['augmentation'], aug_seed,
                                   step)
        else:
            x, m = ((u8.float() / 255.0 - 0.5) / 0.5)[:, None], masks
        x = x.view(accum, micro, *x.shape[1:])
        m = m.view(accum, micro, *m.shape[1:])
        opt.zero_grad(set_to_none=True)
        total = 0.0
        keep = micro // 2 if half_batch else micro
        for a in range(accum):
            loss = dice_bce(net(x[a, :keep]), m[a, :keep],
                            loss_cfg['ce_weight'],
                            loss_cfg['dice_weight'],
                            loss_cfg['balanced_class_weight'])
            loss.backward()
            total += float(loss.detach())
        out['loss'].append(total)
        params = list(net.parameters())
        with torch.no_grad():
            for p in params:
                p.grad.div_(accum)
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(p.grad) for p in params]))
            out['grad_norm'].append(float(norm))
            if float(norm) >= tr['grad_clip']:
                for p in params:
                    p.grad.mul_(tr['grad_clip'] / norm)
        if step == 0:
            out['grad'] = {k: float(torch.linalg.vector_norm(p.grad))
                           for k, p in net.named_parameters()}
        opt.step()
    now = net.state_dict()
    out['change'] = {k: float(torch.linalg.vector_norm(now[k] - init[k]))
                     for k, _ in net.named_parameters()}
    out['stats'] = {k: float(torch.linalg.vector_norm(now[k] - init[k]))
                    for k in now if k.endswith(('running_mean',
                                                'running_var'))}
    out['tracked'] = {k: int(now[k]) for k in now
                      if k.endswith('num_batches_tracked')}
    return out


def _leaf_gaps(got: Dict[str, float], want: Dict[str, float],
               keys: List[str]) -> Dict[str, float]:
    """|got - want| of each leaf in ``keys``, against the larger of its
    own ``want`` and the median leaf's."""
    med = statistics.median(want[k] for k in keys)
    return {k: abs(got[k] - want[k]) / max(want[k], med) for k in keys}


def compare(got: Dict, want: Dict) -> Dict[str, float]:
    """The numbers that decide a training cell's ``correct``:

    * ``loss``: the largest relative gap of a step's summed loss;
    * ``grad``: the worst leaf's gap of first-gradient norms;
    * ``change``: the worst leaf's gap of the parameters' change;
    * ``stats``: the worst leaf's gap of the running statistics' change;
    * ``tracked``: the BatchNorm update counts that differ (exact).

    Leaves whose reference gradient is under a thousandth of the median
    leaf's are left out of ``grad`` and ``change``: they move by
    round-off alone (none does in these networks, whose 3x3 and gate
    convolutions have no bias)."""
    med = statistics.median(want['grad'].values())
    keys = [k for k, v in want['grad'].items() if v >= 1e-3 * med]
    out = {'loss': max(abs(g - w) / abs(w)
                       for g, w in zip(got['loss'], want['loss']))}
    for name, leaves in (('grad', keys), ('change', keys),
                         ('stats', sorted(want['stats']))):
        gaps = _leaf_gaps(got[name], want[name], leaves)
        worst = max(gaps, key=gaps.get)
        out[name] = gaps[worst]
        out[name + '_median'] = statistics.median(gaps.values())
        out[name + '_leaf'] = worst
    out['tracked'] = float(sum(got['tracked'][k] != v
                               for k, v in want['tracked'].items()))
    return out
