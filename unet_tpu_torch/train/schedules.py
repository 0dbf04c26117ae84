"""Per-epoch learning-rate schedules with the reference's semantics.

Counterpart of ``unet_tpu/train/schedules.py`` (functions of the epoch,
not ``torch.optim.lr_scheduler`` objects): the train loop sets the
optimizer's learning rate from them once per epoch.

* cosine_annealing: torch CosineAnnealingLR(T_max=epochs, eta_min=min_lr)
* warmup_cosine: linear warmup from warmup_lr to lr over warmup_epochs,
  then cosine decay toward 0 (not min_lr)
* reduce_on_plateau: host-side reduction on the monitored metric, with
  torch's relative threshold
"""

from __future__ import annotations

import math
from typing import Callable, Dict


def cosine_annealing(base_lr: float, total_epochs: int,
                     min_lr: float = 1e-6) -> Callable[[int], float]:
    """lr(epoch) for torch CosineAnnealingLR stepped once per epoch."""
    def lr(epoch: int) -> float:
        return min_lr + (base_lr - min_lr) * 0.5 * (
            1 + math.cos(math.pi * epoch / total_epochs))
    return lr


def warmup_cosine(base_lr: float, warmup_epochs: int, total_epochs: int,
                  warmup_lr: float = 1e-6) -> Callable[[int], float]:
    """lr(epoch) for the reference's LambdaLR warmup+cosine
    (scripts/train.py:38-58): linear ramp warmup_lr -> base_lr, then
    0.5*(1+cos(pi*progress)) decay toward zero."""
    ratio = warmup_lr / base_lr

    def lr(epoch: int) -> float:
        if epoch < warmup_epochs:
            factor = ratio + (1 - ratio) * (epoch / warmup_epochs)
        else:
            progress = (epoch - warmup_epochs) / (total_epochs - warmup_epochs)
            factor = 0.5 * (1 + math.cos(math.pi * progress))
        return base_lr * factor
    return lr


class ReduceLROnPlateau:
    """Host-side plateau scheduler matching torch defaults
    (threshold 1e-4, rel mode) plus the reference wrapper's
    ``num_reductions`` bookkeeping (callbacks.py:241-309).

    Call ``step(metric)`` once per epoch; read ``.lr``. Returns True when
    the LR was reduced this step.
    """

    def __init__(self, base_lr: float, mode: str = 'max', factor: float = 0.5,
                 patience: int = 10, min_lr: float = 1e-6,
                 threshold: float = 1e-4):
        if mode not in ('min', 'max'):
            raise ValueError(f'mode must be min or max, got {mode}')
        self.lr = base_lr
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.threshold = threshold
        self.best = -math.inf if mode == 'max' else math.inf
        self.num_bad_epochs = 0
        self.num_reductions = 0

    def _is_better(self, value: float) -> bool:
        if not math.isfinite(self.best):
            return True
        # torch rel threshold mode: max -> a > best*(1+eps), min -> a <
        # best*(1-eps). Metrics here (dice) are non-negative.
        if self.mode == 'max':
            return value > self.best * (1.0 + self.threshold)
        return value < self.best * (1.0 - self.threshold)

    def step(self, metric: float) -> bool:
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
            return False
        self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            old = self.lr
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.num_bad_epochs = 0
            if self.lr < old:
                self.num_reductions += 1
                return True
        return False

    def state_dict(self) -> Dict:
        return {k: getattr(self, k) for k in
                ('lr', 'best', 'num_bad_epochs', 'num_reductions')}

    def load_state_dict(self, state: Dict) -> None:
        for k, v in state.items():
            setattr(self, k, v)


def create_scheduler(scheduler_cfg: Dict, base_lr: float, total_epochs: int):
    """Scheduler factory mirroring ref train.py:352-388.

    Returns (kind, schedule) where kind is 'epoch' (callable epoch->lr)
    or 'plateau' (ReduceLROnPlateau instance).
    """
    stype = (scheduler_cfg or {}).get('type', 'reduce_on_plateau')
    if stype == 'cosine_annealing':
        return 'epoch', cosine_annealing(
            base_lr, total_epochs, scheduler_cfg.get('min_lr', 1e-6))
    if stype == 'warmup_cosine':
        return 'epoch', warmup_cosine(
            base_lr, scheduler_cfg.get('warmup_epochs', 5), total_epochs,
            scheduler_cfg.get('warmup_lr', 1e-6))
    return 'plateau', ReduceLROnPlateau(
        base_lr, mode='max', factor=scheduler_cfg.get('factor', 0.5),
        patience=scheduler_cfg.get('patience', 10),
        min_lr=scheduler_cfg.get('min_lr', 1e-6))
