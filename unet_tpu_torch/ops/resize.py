"""Resize ops with ``align_corners=True`` semantics on NCHW tensors.

Counterpart of ``unet_tpu/ops/resize.py``. The JAX package writes the
align-corners lerp as gather tables (or MXU matmuls on a TPU); here it
is ATen's ``F.interpolate``, which implements the same coordinate map
``src = i * (in - 1) / (out - 1)``.

``resize_rows_align_corners`` is the band form the height-sharded
forward (``core/spatial.py``) needs: a band of output rows from the
source rows it reads, on the global coordinates.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
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


def _taps(in_size: int, out_size: int, start: int, stop: int,
          device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ATen's align-corners taps of output indices [start, stop): the
    lower source index, its neighbour (itself at the last index) and the
    float32 weight of the neighbour, ``src = i * ((in - 1) / (out - 1))``
    with the scale rounded to float32 first, as ATen computes it. Built
    on ``device`` from host scalars, so the host never waits on it."""
    scale = (float(np.float32(in_size - 1) / np.float32(out_size - 1))
             if out_size > 1 else 0.0)
    src = torch.arange(start, stop, dtype=torch.float32,
                       device=device) * scale
    lo = src.long().clamp(max=in_size - 1)
    hi = torch.where(lo < in_size - 1, lo + 1, lo)
    return lo, hi, src - lo


def source_rows(in_h: int, out_h: int, start: int, stop: int
                ) -> Tuple[int, int]:
    """The source rows [lo, hi) that output rows [start, stop) of an
    align-corners resize from height ``in_h`` to ``out_h`` read."""
    lo, hi, _ = _taps(in_h, out_h, start, stop, 'cpu')
    return int(lo.min()), int(hi.max()) + 1


def resize_rows_align_corners(x: torch.Tensor, row0: int, in_h: int,
                              out_h: int, out_w: int, start: int,
                              stop: int) -> torch.Tensor:
    """Rows [start, stop) of ``resize_bilinear_align_corners(X, out_h,
    out_w)``, where ``x`` holds rows [row0, row0 + x.shape[2]) of X (of
    height ``in_h``, width ``x.shape[3]``), at least the rows
    ``source_rows`` names. The lerps run in float32 (rows, then columns)
    and the result is rounded once to x's dtype, as ATen's kernels
    accumulate; ATen's own kernel blends the four taps in another order,
    so float32 results agree to rounding."""
    lo, hi, wr = _taps(in_h, out_h, start, stop, x.device)
    xf = x.float()
    top = xf.index_select(2, lo - row0)
    bot = xf.index_select(2, hi - row0)
    rows = top + (bot - top) * wr.view(1, 1, -1, 1)
    lo, hi, wc = _taps(x.shape[3], out_w, 0, out_w, x.device)
    left = rows.index_select(3, lo)
    right = rows.index_select(3, hi)
    out = left + (right - left) * wc.view(1, 1, 1, -1)
    return out.to(x.dtype).contiguous(memory_format=torch.channels_last)
