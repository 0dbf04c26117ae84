"""Weights from the seed, made on the device in a few large calls.

The configuration's reference module (``common.load_reference``) names
the network and, by its ``init_plan``, how each leaf of its state dict
starts:

* ``('uniform', fan_in)``: U(+-1/sqrt(fan_in)), torch's default draw;
* ``('normal', std)``: N(0, std^2);
* ``('ones',)`` or ``('zeros',)``.

The uniform leaves are cut, in state-dict order, from one uniform draw
of a generator on the device seeded with the seed; the normal leaves,
in the same order, from one normal draw of that generator after it; the
others are filled. Every leaf keeps the dtype the network gives it.
"""

from __future__ import annotations

import math
from types import ModuleType
from typing import Dict

import torch

UNIFORM, NORMAL, ONES, ZEROS = 'uniform', 'normal', 'ones', 'zeros'


def seeded_state(arch: ModuleType, model_cfg: Dict, seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """The state dict of the network ``model_cfg`` describes, on
    ``device``, drawn from ``seed`` as ``arch.init_plan`` says."""
    with torch.device('meta'):
        # names, shapes and dtypes of the leaves, nothing allocated
        meta = arch.Net(model_cfg).state_dict()
    plan = arch.init_plan({k: v.shape for k, v in meta.items()})
    if set(plan) != set(meta):
        raise ValueError('the init plan and the state dict name different '
                         f'leaves: {sorted(set(plan) ^ set(meta))}')
    for k, kind in plan.items():
        if kind[0] not in (UNIFORM, NORMAL, ONES, ZEROS):
            raise ValueError(f'{k}: unknown init {kind!r}')
    gen = torch.Generator(device=device).manual_seed(seed)
    state = {}
    for kind in (UNIFORM, NORMAL):
        keys = [k for k in meta if plan[k][0] == kind]
        if not keys:
            continue
        total = sum(meta[k].numel() for k in keys)
        if kind == UNIFORM:
            flat = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
        else:
            flat = torch.randn(total, generator=gen, device=device)
        offset = 0
        for k in keys:
            n = meta[k].numel()
            piece = flat[offset:offset + n].view(meta[k].shape)
            piece = (piece / math.sqrt(plan[k][1]) if kind == UNIFORM
                     else piece * plan[k][1])
            state[k] = piece.to(meta[k].dtype)
            offset += n
    for k, v in meta.items():
        if plan[k][0] in (ONES, ZEROS):
            fill = torch.ones if plan[k][0] == ONES else torch.zeros
            state[k] = fill(v.shape, dtype=v.dtype, device=device)
    return {k: state[k] for k in meta}
