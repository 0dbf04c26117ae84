"""Training callbacks: early stopping and checkpoints.

Counterpart of ``unet_tpu/train/callbacks.py``. ``CheckpointManager``
writes the reference torch project's ModelCheckpoint payload,
``{epoch, model_state_dict, optimizer_state_dict, metrics, config}``, as
``<save_dir>/{last,best}/model.pt``, with the port's real AdamW state,
and a ``meta.json`` beside it (epoch, optimizer step, metrics, config,
scheduler state, monitor and its value). ``last`` is written every
epoch, ``best`` when the monitored metric improves. Every file is
written to a temporary name and renamed into place, so a crash never
leaves half a checkpoint.
"""

from __future__ import annotations

import json
import math
import os
from pathlib import Path
from typing import Dict, Optional

import torch

from unet_tpu_torch.utils.config import get_nested_metric


class EarlyStopping:
    """Stop when the monitored score stops improving for ``patience``
    epochs."""

    def __init__(self, patience: int = 20, mode: str = 'max',
                 min_delta: float = 0.0):
        if mode not in ('min', 'max'):
            raise ValueError(f'mode must be min or max, got {mode}')
        self.patience = patience
        self.mode = mode
        self.min_delta = min_delta
        self.reset()

    def reset(self) -> None:
        self.best = -math.inf if self.mode == 'max' else math.inf
        self.counter = 0
        self.stopped = False

    def _improved(self, score: float) -> bool:
        if self.mode == 'max':
            return score > self.best + self.min_delta
        return score < self.best - self.min_delta

    def __call__(self, score: float) -> bool:
        if self._improved(score):
            self.best = score
            self.counter = 0
            return False
        self.counter += 1
        if self.counter >= self.patience:
            self.stopped = True
            return True
        return False


def _cpu(tree):
    """A copy of a (nested) state dict with every tensor on the CPU."""
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def _atomic_write(path: Path, write) -> None:
    tmp = path.with_name(path.name + '.tmp')
    write(tmp)
    os.replace(tmp, path)


class CheckpointManager:
    """Saves ``last`` every epoch and ``best`` on monitored improvement::

        save_dir/
          last/  model.pt   (reference payload)
                 meta.json  (epoch, step, metrics, config, scheduler,
                             monitor, monitor_value)
          best/  ...same...
    """

    def __init__(self, save_dir, monitor: str = 'class_dice.tumor',
                 mode: str = 'max', save_last: bool = True,
                 save_best: bool = True):
        self.save_dir = Path(save_dir)
        self.save_dir.mkdir(parents=True, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self.save_last = save_last
        self.save_best = save_best
        self.best_value = -math.inf if mode == 'max' else math.inf
        self.best_epoch = -1

    def _write(self, name: str, model_state: Dict, optimizer_state: Dict,
               epoch: int, metrics: Dict, config: Optional[Dict],
               scheduler_state: Optional[Dict], step: Optional[int]) -> None:
        path = self.save_dir / name
        path.mkdir(parents=True, exist_ok=True)
        payload = {'epoch': int(epoch),
                   'model_state_dict': _cpu(model_state),
                   'optimizer_state_dict': _cpu(optimizer_state),
                   'metrics': metrics,
                   'config': config}
        _atomic_write(path / 'model.pt', lambda p: torch.save(payload, p))
        meta = {
            'epoch': int(epoch),
            'step': None if step is None else int(step),
            'metrics': metrics,
            'config': config,
            'scheduler': scheduler_state,
            'monitor': self.monitor,
            'monitor_value': get_nested_metric(metrics, self.monitor),
        }
        _atomic_write(path / 'meta.json',
                      lambda p: p.write_text(json.dumps(meta, default=float)))

    def save(self, model_state: Dict, optimizer_state: Dict, epoch: int,
             metrics: Dict, config: Optional[Dict] = None,
             scheduler_state: Optional[Dict] = None,
             step: Optional[int] = None) -> bool:
        """Write ``last`` (and ``best`` on improvement) from the validated
        weights' state dict and the optimizer's. Returns True when this
        epoch improved the monitored metric."""
        args = (model_state, optimizer_state, epoch, metrics, config,
                scheduler_state, step)
        if self.save_last:
            self._write('last', *args)
        value = get_nested_metric(metrics, self.monitor)
        improved = (value > self.best_value if self.mode == 'max'
                    else value < self.best_value)
        if improved:
            self.best_value = value
            self.best_epoch = epoch
            if self.save_best:
                self._write('best', *args)
        return improved
