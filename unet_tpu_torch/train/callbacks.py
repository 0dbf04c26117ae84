"""Training callbacks: early stopping and checkpoints.

Counterpart of ``unet_tpu/train/callbacks.py``. ``CheckpointManager``
writes the reference torch project's ModelCheckpoint payload,
``{epoch, model_state_dict, optimizer_state_dict, metrics, config}``, as
``<save_dir>/{last,best}/model.pt``, with the port's real AdamW state,
a ``meta.json`` beside it (epoch, optimizer step, metrics, config,
scheduler state, monitor and its value), and ``train_state.pt`` with
what a resume needs beyond that payload (the training model's weights,
which differ from the validated ones when those are the EMA's, the EMA
shadow and the augmentation step counter). ``last`` is written every
epoch, ``best`` when the monitored metric improves. Every file is
written to a temporary name and renamed into place, so a crash never
leaves half a file.
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
               scheduler_state: Optional[Dict], step: Optional[int],
               train_state: Optional[Dict]) -> None:
        path = self.save_dir / name
        path.mkdir(parents=True, exist_ok=True)
        payload = {'epoch': int(epoch),
                   'model_state_dict': _cpu(model_state),
                   'optimizer_state_dict': _cpu(optimizer_state),
                   'metrics': metrics,
                   'config': config}
        _atomic_write(path / 'model.pt', lambda p: torch.save(payload, p))
        if train_state is not None:
            _atomic_write(path / 'train_state.pt',
                          lambda p: torch.save(_cpu(train_state), p))
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
             step: Optional[int] = None,
             train_state: Optional[Dict] = None) -> bool:
        """Write ``last`` (and ``best`` on improvement) from the validated
        weights' state dict and the optimizer's; ``train_state`` (a dict
        of tensors and numbers) goes to ``train_state.pt`` for resuming.
        Returns True when this epoch improved the monitored metric."""
        args = (model_state, optimizer_state, epoch, metrics, config,
                scheduler_state, step, train_state)
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

    # ---- restore ----
    @staticmethod
    def restorable(path) -> bool:
        """Whether a checkpoint directory holds all a resume reads."""
        path = Path(path)
        return all((path / f).exists() for f in
                   ('model.pt', 'meta.json', 'train_state.pt'))

    @staticmethod
    def find_auto_resume(save_root, experiment_name: str) -> Optional[Path]:
        """``--resume auto``: the newest run directory (exp, exp2, exp3,
        ...) under ``save_root`` holding a restorable checkpoint, as its
        ``weights/last`` (or ``weights/best`` when ``last`` is not
        restorable), or None for a fresh start."""
        root = Path(save_root)

        def suffix_num(p: Path) -> int:
            s = p.name[len(experiment_name):]
            return int(s) if s.isdigit() else 1

        def checkpoint(run: Path) -> Optional[Path]:
            for name in ('last', 'best'):
                c = run / 'weights' / name
                if CheckpointManager.restorable(c):
                    return c
            return None

        runs = [p for p in root.glob(f'{experiment_name}*')
                if (p.name == experiment_name
                    or p.name[len(experiment_name):].isdigit())
                and checkpoint(p) is not None]
        if not runs:
            return None
        return checkpoint(max(runs, key=suffix_num))

    @staticmethod
    def read_meta(path) -> Dict:
        return json.loads((Path(path) / 'meta.json').read_text())

    @staticmethod
    def load(path) -> Dict:
        """Everything a resume reads from a checkpoint directory:
        ``{'meta', 'payload' (model.pt), 'train_state'}``, on the CPU."""
        path = Path(path)
        load = lambda f: torch.load(path / f, map_location='cpu',
                                    weights_only=False)
        return {'meta': CheckpointManager.read_meta(path),
                'payload': load('model.pt'),
                'train_state': load('train_state.pt')}
