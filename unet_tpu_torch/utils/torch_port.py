"""Weights between the JAX package's variables and the port's modules.

Counterpart of ``unet_tpu/utils/torch_port.py`` (its own copy: this
package imports neither flax nor ``unet_tpu``). The port's modules use
the reference torch project's names, so a reference-format ``.pt`` loads
straight into them; ``state_dict_from_jax`` carries a flax
``{'params', 'batch_stats'}`` tree over. Name mapping:

  inc/{conv1,bn1,conv2,bn2}        -> inc.double_conv.{0,1,3,4}
  downN/conv/...                   -> downN.maxpool_conv.1.double_conv...
  upN/conv/...                     -> upN.conv.double_conv...
  upN/up (ConvTranspose)           -> upN.up
  upN/attention/{w_g,bn_g}         -> upN.attention.{W_g.0,W_g.1}
  upN/attention/{w_x,bn_x}         -> upN.attention.{W_x.0,W_x.1}
  upN/attention/{psi,bn_psi}       -> upN.attention.{psi.0,psi.1}
  outc/conv, ds_outN/conv          -> outc.conv, ds_outN.conv

Layouts: conv HWIO -> OIHW; transposed conv HWIO -> IOHW with the 2x2
taps flipped (flax realises the transposed conv as a convolution, so
its taps land mirrored against torch's adjoint-of-correlation).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Tuple

import numpy as np
import torch

_DC = {'conv1': '0', 'bn1': '1', 'conv2': '3', 'bn2': '4'}
_ATT = {'w_g': 'W_g.0', 'bn_g': 'W_g.1', 'w_x': 'W_x.0', 'bn_x': 'W_x.1',
        'psi': 'psi.0', 'bn_psi': 'psi.1'}
_LEAF = {'kernel': 'weight', 'scale': 'weight', 'bias': 'bias',
         'mean': 'running_mean', 'var': 'running_var'}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()
             ) -> Dict[Tuple[str, ...], Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _torch_prefix(path) -> str:
    """Translate a flax module path (up to the leaf module) to the torch
    parameter prefix."""
    parts = list(path)
    out = []
    i = 0
    while i < len(parts):
        p = parts[i]
        nxt = parts[i + 1] if i + 1 < len(parts) else None
        if p == 'inc':
            out.append('inc.double_conv')
        elif p.startswith('down') and nxt == 'conv':
            out.append(f'{p}.maxpool_conv.1.double_conv')
            i += 1
        elif p.startswith('up') and nxt == 'conv':
            out.append(f'{p}.conv.double_conv')
            i += 1
        elif p.startswith('up') and nxt == 'up':
            out.append(f'{p}.up')
            i += 1
        elif p == 'attention':
            out.append(f'attention.{_ATT[nxt]}')
            i += 1
        elif p in _DC:
            out.append(_DC[p])
        else:
            out.append(p)
        i += 1
    return '.'.join(out)


def state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The port's state dict from the JAX package's variables
    (``{'params', 'batch_stats'}``, nested mappings of arrays): reference
    names, OIHW / IOHW layouts, float32 values unchanged, plus the
    ``num_batches_tracked`` counters torch BatchNorm carries."""
    out: Dict[str, torch.Tensor] = {}
    for coll in ('params', 'batch_stats'):
        if coll not in variables:
            continue
        for path, arr in _flatten(variables[coll]).items():
            *mods, leaf = path
            prefix = _torch_prefix(mods)
            arr = np.asarray(arr)
            if leaf == 'kernel':
                if mods and mods[-1] == 'up':  # ConvTranspose2d: (I, O, kh, kw)
                    arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)
                else:                          # Conv2d: (O, I, kh, kw)
                    arr = arr.transpose(3, 2, 0, 1)
            out[f'{prefix}.{_LEAF[leaf]}'] = torch.from_numpy(np.array(arr))
            if coll == 'batch_stats' and leaf == 'mean':
                out[f'{prefix}.num_batches_tracked'] = torch.tensor(
                    0, dtype=torch.long)
    return out


def load_torch_checkpoint(path):
    """Load a reference ``.pt`` checkpoint file: the ModelCheckpoint
    payload ``{epoch, model_state_dict, optimizer_state_dict, metrics[,
    config]}`` or a bare state dict. Returns ``(state_dict, config,
    epoch)``. Unpickles the file, so load only checkpoints you trust."""
    ckpt = torch.load(path, map_location='cpu', weights_only=False)
    if isinstance(ckpt, dict) and 'model_state_dict' in ckpt:
        return (ckpt['model_state_dict'], ckpt.get('config') or {},
                ckpt.get('epoch'))
    return ckpt, {}, None
