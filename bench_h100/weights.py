"""Weights from the seed, made on the device in a few large calls.

Convolution weights (and the head's bias) are torch's default draw,
U(+-1/sqrt(fan_in)), taken from one uniform draw of a generator on the
device and cut into leaves; BatchNorm starts at weight 1, bias 0,
statistics (0, 1).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from bench_h100.reference.model import Net


def leaf_shapes(model_cfg: Dict) -> Dict[str, torch.Size]:
    with torch.device('meta'):
        net = Net(model_cfg)
    return {k: v.shape for k, v in net.state_dict().items()}


def seeded_state(model_cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict of the network ``model_cfg`` describes, float32 on
    ``device``, drawn from ``seed``."""
    shapes = leaf_shapes(model_cfg)
    drawn = [k for k, s in shapes.items()
             if k.endswith('.weight') and len(s) == 4]
    drawn += [k for k in shapes if k == 'outc.conv.bias']
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(shapes[k]) for k in drawn)
    u = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    state, offset = {}, 0
    for k in drawn:
        s = shapes[k]
        wshape = shapes[k.replace('.bias', '.weight')]
        fan_in = wshape[1] * wshape[2] * wshape[3]
        n = math.prod(s)
        state[k] = u[offset:offset + n].view(s) / math.sqrt(fan_in)
        offset += n
    for k, s in shapes.items():
        if k in state:
            continue
        if k.endswith('num_batches_tracked'):
            state[k] = torch.zeros((), dtype=torch.long, device=device)
        elif k.endswith(('running_var', '.weight')):
            state[k] = torch.ones(s, device=device)
        else:
            state[k] = torch.zeros(s, device=device)
    return {k: state[k] for k in shapes}
