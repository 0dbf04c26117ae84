"""Resize ops with ``align_corners=True`` semantics on NCHW tensors.

Counterpart of ``unet_tpu/ops/resize.py``. The JAX package writes the
align-corners lerp as gather tables (or MXU matmuls on a TPU); here it
is ATen's ``F.interpolate``, which implements the same coordinate map
``src = i * (in - 1) / (out - 1)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int,
                                  out_w: int) -> torch.Tensor:
    """Bilinear align-corners resize of an (N, C, H, W) tensor."""
    if x.shape[-2:] == (out_h, out_w):
        return x
    return F.interpolate(x, size=(out_h, out_w), mode='bilinear',
                         align_corners=True)


def upsample2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear align-corners upsample, as used by Up/AttentionUp."""
    return resize_bilinear_align_corners(x, 2 * x.shape[-2],
                                         2 * x.shape[-1])


def pad_to_match(x: torch.Tensor, target_h: int,
                 target_w: int) -> torch.Tensor:
    """Zero-pad the spatial dims to (target_h, target_w), with
    ``diff // 2`` on the top/left and the rest on the bottom/right."""
    dh = target_h - x.shape[-2]
    dw = target_w - x.shape[-1]
    if dh == 0 and dw == 0:
        return x
    return F.pad(x, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
