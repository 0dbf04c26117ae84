"""Bit-packed binary masks for the device->host readback wire.

Counterpart of ``unet_tpu/ops/bitpack.py``: thresholding runs on the
device and only 1 bit per pixel crosses the link (32x less than f32
probabilities). Bit order is numpy's ``packbits`` default: the first
pixel of each group of 8 goes to the most significant bit.
"""

import numpy as np
import torch

__all__ = ['pack_masks_device', 'unpack_masks_host']


def pack_masks_device(masks: torch.Tensor) -> torch.Tensor:
    """(..., W) {0,1} bool/int tensor -> (..., ceil(W/8)) uint8, on the
    tensor's own device. W is zero-padded up to a multiple of 8."""
    w = masks.shape[-1]
    m = masks.to(torch.int32)
    pad = (-w) % 8
    if pad:
        m = torch.nn.functional.pad(m, (0, pad))
    m = m.reshape(*m.shape[:-1], m.shape[-1] // 8, 8)
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=m.device)
    return (m << shifts).sum(dim=-1).to(torch.uint8)


def unpack_masks_host(packed: np.ndarray, width: int) -> np.ndarray:
    """Host-side inverse: (..., ceil(W/8)) uint8 -> (..., width) uint8
    in {0, 1}."""
    out = np.unpackbits(np.asarray(packed, np.uint8), axis=-1)
    return out[..., :width]
