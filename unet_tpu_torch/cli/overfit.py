#!/usr/bin/env python
"""Overfit sanity harness: can the whole stack drive tumor Dice above
0.8 on a handful of samples?

Counterpart of ``unet_tpu/cli/overfit.py``, with its flags and defaults:
pick the N slices with the largest tumors among those with more than 100
tumor pixels, train on just those with plain Adam (lr 1e-3, 200 epochs,
one microbatch of the whole sample set per step; ``attention_unet``
forces deep supervision), evaluate in eval mode after every step, and
PASS iff the final tumor Dice is above 0.8. ``--synthetic`` makes it a
dataset-free end-to-end check. Runs on CUDA in bfloat16 unless
``--device cpu`` asks for the CPU, where it runs in float32.

    python -m unet_tpu_torch.cli.overfit --synthetic --model attention_unet
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

PASS_DICE = 0.8


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Overfit sanity test')
    p.add_argument('--data', type=str, default='./dataset')
    p.add_argument('--samples', type=int, default=4)
    p.add_argument('--epochs', type=int, default=200)
    p.add_argument('--lr', type=float, default=1e-3)
    p.add_argument('--loss', type=str, default='dice_bce',
                   choices=['dice_bce', 'dice', 'ce'])
    p.add_argument('--model', type=str, default='unet',
                   choices=['unet', 'attention_unet'])
    p.add_argument('--img-size', type=int, default=256)
    p.add_argument('--synthetic', action='store_true')
    p.add_argument('--output', type=str, default='overfit_results')
    p.add_argument('--base-features', type=int, default=64)
    p.add_argument('--device', type=str, default=None,
                   help='"cpu" runs on the CPU; default CUDA')
    return p.parse_args(argv)


def select_samples(ds, n: int):
    """Indices and tumor areas of the ``n`` slices with the largest tumors
    among those with more than 100 tumor pixels, largest first."""
    areas = []
    for i in range(len(ds)):
        _, m = ds.load(i)
        a = int(m.sum())
        if a > 100:
            areas.append((a, i))
    areas.sort(reverse=True)
    return [i for _, i in areas[:n]], [a for a, _ in areas[:n]]


def run_overfit(args) -> dict:
    """Train and evaluate; returns ``{'passed', 'final_dice', 'picked',
    'history'}``."""
    from unet_tpu_torch import resolve_device
    from unet_tpu_torch.data.augmentations import normalize_batch
    from unet_tpu_torch.data.dataset import (SliceDataset,
                                             SyntheticSliceDataset)
    from unet_tpu_torch.models import create_model
    from unet_tpu_torch.train.losses import create_loss_function
    from unet_tpu_torch.train.metrics import SegmentationMetrics
    from unet_tpu_torch.train.trainer import make_eval_step, make_train_step
    from unet_tpu_torch.utils import plots

    device = resolve_device(args.device or None)
    out_dir = Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    draw = plots.have_matplotlib()
    if not draw:
        print(plots.SKIP_MESSAGE)

    if args.synthetic:
        ds = SyntheticSliceDataset(num_volumes=4, slices_per_volume=4,
                                   img_size=args.img_size, split='all',
                                   tumor_prob=1.0,
                                   tumor_radius=(0.08, 0.15))
    else:
        ds = SliceDataset(args.data, split='train', img_size=args.img_size)
    picked, areas = select_samples(ds, args.samples)
    if not picked:
        print('FAIL: no slices with >100 tumor pixels found')
        return {'passed': False, 'final_dice': 0.0, 'picked': [],
                'history': {}}
    print(f'Selected {len(picked)} samples with tumor areas {areas}')

    samples = [ds.load(i) for i in picked]
    images = np.stack([s[0] for s in samples])[:, None]    # (N, 1, H, W)
    masks = np.stack([s[1] for s in samples]).astype(np.int64)
    if draw:
        plots.plot_predictions((images - 0.5) / 0.5, masks, masks,
                               num_samples=len(picked),
                               save_path=out_dir / 'overfit_samples.png')

    deep_supervision = args.model == 'attention_unet'
    dtype = torch.bfloat16 if device.type == 'cuda' else torch.float32
    model = create_model(args.model, base_features=args.base_features,
                         deep_supervision=deep_supervision, dtype=dtype,
                         generator=torch.Generator().manual_seed(0))
    model = model.to(device, memory_format=torch.channels_last)
    loss_fn = create_loss_function(args.loss,
                                   deep_supervision=deep_supervision)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr, betas=(0.9, 0.999),
                           eps=1e-8)
    train_step = make_train_step(model, loss_fn, opt, accum_steps=1,
                                 grad_clip=0.0)
    eval_step = make_eval_step(model, loss_fn, num_classes=2)

    x = normalize_batch(torch.from_numpy(images).to(device))
    y = torch.from_numpy(masks).to(device)
    mb_mask = np.ones((1,), np.float32)

    metrics = SegmentationMetrics(2, ['background', 'tumor'])
    history = {'train_loss': [], 'tumor_dice': []}
    for epoch in range(args.epochs):
        loss_sum = train_step(x[None], y[None], args.lr, mb_mask)
        _, cm = eval_step(x, y)
        metrics.reset()
        metrics.update_from_matrix(cm)
        dice = metrics.compute()['class_dice']['tumor']
        history['train_loss'].append(float(loss_sum))
        history['tumor_dice'].append(dice)
        if (epoch + 1) % 20 == 0 or epoch == 0:
            print(f'epoch {epoch + 1:4d}: loss={float(loss_sum):.4f} '
                  f'tumor_dice={dice:.4f}')

    final_dice = history['tumor_dice'][-1]
    if draw:
        plots.plot_training_curves(history,
                                   save_path=out_dir / 'overfit_curves.png')
        model.eval()
        with torch.no_grad():
            preds = model(x).argmax(1).cpu().numpy()
        xs = x.float().cpu().numpy()
        plots.plot_predictions(xs, masks, preds, num_samples=len(picked),
                               save_path=out_dir / 'overfit_predictions.png')
        plots.plot_sample_with_overlay(
            xs[0], masks[0], preds[0],
            save_path=out_dir / 'overfit_overlay.png')

    passed = final_dice > PASS_DICE
    print('=' * 60)
    if passed:
        print(f'PASS: final tumor dice {final_dice:.4f} > {PASS_DICE}')
    else:
        print(f'FAIL: final tumor dice {final_dice:.4f} <= {PASS_DICE}')
        print('Diagnosis hints: check data loading (masks nonzero?), '
              'loss wiring (does train loss fall?), lr too small/large, '
              'or too few epochs.')
    return {'passed': passed, 'final_dice': final_dice, 'picked': picked,
            'history': history}


def main(argv=None) -> int:
    """Exit code 0 on PASS, 1 on FAIL."""
    return 0 if run_overfit(parse_args(argv))['passed'] else 1


if __name__ == '__main__':
    sys.exit(main())
