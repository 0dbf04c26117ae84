"""Config loading, run-dir management, seeding, device report.

Counterpart of ``unet_tpu/utils/config.py``: the same YAML schema and
key semantics (``configs/lung_tumor.yaml``), with torch's device view.
"""

from __future__ import annotations

import random
from pathlib import Path
from typing import Dict, Union

import numpy as np
import torch
import yaml


def load_config(config_path: Union[str, Path]) -> Dict:
    """Load a YAML config."""
    config_path = Path(config_path)
    if not config_path.exists():
        raise FileNotFoundError(f'Config file not found: {config_path}')
    with open(config_path) as f:
        return yaml.safe_load(f)


def increment_path(path: Union[str, Path], sep: str = '') -> Path:
    """runs/exp -> runs/exp2 -> runs/exp3 ... (the first free name)."""
    path = Path(path)
    if not path.exists():
        return path
    for n in range(2, 1000):
        candidate = Path(f'{path}{sep}{n}')
        if not candidate.exists():
            return candidate
    raise RuntimeError(f'Could not find a free run dir for {path}')


def set_seed(seed: int = 42) -> None:
    """Seed python's, numpy's and torch's global generators. The train
    loop's own draws (model init, augmentation) use explicit
    generators seeded from the config's seed."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def describe_devices(device: torch.device) -> str:
    """Human-readable summary of the device a run uses."""
    device = torch.device(device)
    if device.type == 'cuda':
        names = {}
        for i in range(torch.cuda.device_count()):
            name = torch.cuda.get_device_name(i)
            names[name] = names.get(name, 0) + 1
        parts = ', '.join(f'{n}x {k}' for k, n in names.items())
        return f'cuda ({parts}; running on {device})'
    return device.type


_VALID_SCHEDULERS = ('cosine_annealing', 'warmup_cosine',
                     'reduce_on_plateau')
_VALID_LOSSES = ('dice', 'ce', 'crossentropy', 'balanced_ce', 'dice_bce')
_VALID_MODELS = ('unet', 'attention_unet', 'attention')


def validate_config(cfg: Dict) -> Dict:
    """Light schema validation: model, loss and scheduler types, and an
    image size the four pooling levels can take."""
    model = cfg.get('model', {})
    mtype = model.get('type', 'unet').lower()
    if mtype not in _VALID_MODELS:
        raise ValueError(f"model.type '{mtype}' not in {_VALID_MODELS}")
    loss = cfg.get('loss', {})
    ltype = loss.get('type', 'dice_bce').lower()
    if ltype not in _VALID_LOSSES:
        raise ValueError(f"loss.type '{ltype}' not in {_VALID_LOSSES}")
    sched = cfg.get('scheduler', {})
    stype = sched.get('type', 'reduce_on_plateau')
    if stype not in _VALID_SCHEDULERS:
        raise ValueError(
            f"scheduler.type '{stype}' not in {_VALID_SCHEDULERS}")
    img_size = cfg.get('data', {}).get('img_size', 512)
    if img_size < 16:
        raise ValueError(
            f'data.img_size must be >= 16 (4 pooling levels), '
            f'got {img_size}')
    return cfg


def get_nested_metric(results: Dict, key: str) -> float:
    """Nested metric lookup such as 'class_dice.tumor'."""
    if '.' in key:
        val = results
        for part in key.split('.'):
            val = val.get(part, {}) if isinstance(val, dict) else 0.0
        return float(val) if not isinstance(val, dict) else 0.0
    v = results.get(key, 0.0)
    return float(v) if not isinstance(v, dict) else 0.0
