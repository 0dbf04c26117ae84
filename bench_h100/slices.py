"""CT-like slices, made in bulk on the device from a seed.

Each slice is what the train CLI's ``--synthetic`` dataset draws: two
lung-like ellipses over Gaussian noise (0.15 + 0.05 N(0, 1)), and in 90%
of slices one or two round 'tumors' (centre U(0.25, 0.75) of the size,
radius U(0.02, 0.05) of it, brightness + U(0.3, 0.5)) with their mask;
clipped to [0, 1] and stored as uint8.

``epoch_order`` is a frozen copy of the train loader's first shuffle, so
the reference knows which slice each row of a step holds without
reading the program's batches.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


@torch.no_grad()
def ct_slices(seed: int, n: int, size: int, device, chunk: int = 32
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(images uint8 (n, size, size), masks uint8 {0, 1}) on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dev = torch.device(device)
    ax = torch.arange(size, dtype=torch.float32, device=dev)
    yy, xx = ax[:, None], ax[None, :]
    body = torch.zeros(size, size, device=dev)
    for cx in (0.32, 0.68):
        d = ((xx / size - cx) / 0.18) ** 2 + ((yy / size - 0.5) / 0.3) ** 2
        body += 0.35 * torch.exp(-d * 3.0)
    imgs, masks = [], []
    for start in range(0, n, chunk):
        m = min(chunk, n - start)

        def u(lo, hi, *shape):
            return torch.rand(*shape, generator=gen, device=dev) * (hi - lo) + lo

        img = 0.15 + 0.05 * torch.randn(m, size, size, generator=gen,
                                        device=dev) + body
        has = u(0, 1, m) < 0.9
        blobs = torch.stack([has, has & (u(0, 1, m) < 0.5)], 1)  # (m, 2)
        centre = u(0.25, 0.75, m, 2, 2) * size                   # (m, blob, xy)
        radius = u(0.02, 0.05, m, 2) * size
        lift = u(0.3, 0.5, m, 2)
        mask = torch.zeros(m, size, size, dtype=torch.bool, device=dev)
        for b in range(2):
            inside = ((xx[None] - centre[:, b, 0, None, None]) ** 2
                      + (yy[None] - centre[:, b, 1, None, None]) ** 2
                      < radius[:, b, None, None] ** 2)
            inside &= blobs[:, b, None, None]
            img += inside * lift[:, b, None, None]
            mask |= inside
        imgs.append((img.clamp(0.0, 1.0) * 255).to(torch.uint8))
        masks.append(mask.to(torch.uint8))
    return torch.cat(imgs), torch.cat(masks)


def epoch_order(seed: int, n: int) -> np.ndarray:
    """The first epoch's order of n training slices:
    ``np.random.default_rng(seed)`` shuffles ``arange(n)`` once."""
    order = np.arange(n)
    np.random.default_rng(seed).shuffle(order)
    return order


def train_count(volumes: int, slices_per_volume: int,
                val_ratio: float = 0.2) -> int:
    """Slices in the training split: all but ``int(volumes * val_ratio)``
    volumes."""
    return (volumes - int(volumes * val_ratio)) * slices_per_volume

