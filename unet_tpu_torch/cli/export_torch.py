#!/usr/bin/env python
"""Export a checkpoint directory of the port's train CLI to one
reference-format ``.pt``.

Counterpart of ``unet_tpu/cli/export_torch.py``. The JAX exporter reads
an Orbax directory, which this package cannot (it has no JAX); this one
reads the port's own ``<run>/weights/{last,best}/`` directory
(``model.pt``, ``meta.json``, ``train_state.pt``) and writes the
reference project's ModelCheckpoint payload, the keys that
``unet_tpu/utils/torch_port.py::save_torch_checkpoint`` writes:
``epoch``, ``model_state_dict``, ``optimizer_state_dict``, ``metrics``
and ``config``, with the epoch, metrics and config from ``meta.json``.
The state dict is ``model.pt``'s, tensor for tensor, and the optimizer
state is the run's own AdamW state (the JAX exporter, which has no torch
optimizer state to carry, writes fresh moments).

    python -m unet_tpu_torch.cli.export_torch \\
        --weights runs/exp/weights/best --output best.pt --device cpu

Before it reports success, the written file is loaded back through
``cli/predict.py::load_model`` (a strict state-dict match) on
``--device``: CUDA unless ``--device cpu`` asks for the CPU, which is
all an export needs.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description='Export a checkpoint directory to a reference .pt')
    p.add_argument('--weights', required=True,
                   help='checkpoint directory of the port\'s train CLI '
                        '(e.g. runs/exp/weights/best)')
    p.add_argument('--output', required=True, help='output .pt path')
    p.add_argument('--device', default=None,
                   help='where the written file is loaded back to check '
                        'it: "cpu" needs no GPU; default CUDA')
    return p.parse_args(argv)


def export(weights, output) -> dict:
    """Write ``weights``' reference payload to ``output``; returns the
    checkpoint's ``meta.json``."""
    from unet_tpu_torch.train.callbacks import CheckpointManager

    src = Path(weights)
    if not (src / 'model.pt').is_file():
        raise ValueError(f'{weights} holds no model.pt: not a checkpoint '
                         'directory of the port\'s train CLI (an Orbax '
                         'directory converts with python '
                         'scripts/export_torch.py)')
    meta = CheckpointManager.read_meta(src)
    payload = torch.load(src / 'model.pt', map_location='cpu',
                         weights_only=False)
    out = Path(output)
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save({'epoch': int(meta.get('epoch') or 0),
                'model_state_dict': payload['model_state_dict'],
                'optimizer_state_dict': payload['optimizer_state_dict'],
                'metrics': dict(meta.get('metrics') or {}),
                'config': dict(meta.get('config') or {})}, out)
    return meta


def main(argv=None):
    args = parse_args(argv)
    from unet_tpu_torch import resolve_device
    from unet_tpu_torch.cli.predict import load_model

    device = resolve_device(args.device)
    meta = export(args.weights, args.output)
    load_model(args.output, device=device)
    print(f'exported {args.weights} -> {args.output} '
          f"(epoch {meta.get('epoch')}, "
          f"monitor {meta.get('monitor_value')})")
    return meta


if __name__ == '__main__':
    main()
