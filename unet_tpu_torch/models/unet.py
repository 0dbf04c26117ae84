"""UNet / Attention U-Net as PyTorch modules.

Counterpart of ``unet_tpu/models/unet.py``: a 4-level encoder (base 64:
64/128/256/512, bottleneck 1024 // factor with factor 2 when bilinear),
a decoder of Up/AttentionUp blocks and a 1x1 OutConv head. AttentionUNet
keeps its optional deep-supervision heads in the parameter tree; in
training mode it returns ``(logits, ds1, ds2, ds3)``, the heads on the
1/2, 1/4 and 1/8 decoder maps upsampled (align-corners, float32) to the
input size, and in eval mode only the logits.

I/O: input (N, n_channels, H, W) float, output float32 logits
(N, n_classes, H, W). The network runs in ``dtype`` in channels_last
memory; parameters stay float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from unet_tpu_torch.models.layers import (AttentionUp, DoubleConv, Down,
                                          OutConv, Up)
from unet_tpu_torch.ops.resize import resize_bilinear_align_corners


class _ParamCount:
    def get_num_params(self, trainable_only: bool = True) -> int:
        """Parameter count; BatchNorm running stats are buffers and never
        counted."""
        return sum(p.numel() for p in self.parameters()
                   if p.requires_grad or not trainable_only)


def _prepare(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(dtype=dtype, memory_format=torch.channels_last)


class UNet(_ParamCount, nn.Module):
    """Vanilla U-Net."""

    def __init__(self, n_channels: int = 1, n_classes: int = 2,
                 bilinear: bool = True, base_features: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_channels, self.n_classes = n_channels, n_classes
        self.bilinear, self.dtype = bilinear, dtype
        f = base_features
        factor = 2 if bilinear else 1
        self.inc = DoubleConv(n_channels, f)
        self.down1 = Down(f, f * 2)
        self.down2 = Down(f * 2, f * 4)
        self.down3 = Down(f * 4, f * 8)
        self.down4 = Down(f * 8, f * 16 // factor)
        self.up1 = Up(f * 16, f * 8 // factor, bilinear)
        self.up2 = Up(f * 8, f * 4 // factor, bilinear)
        self.up3 = Up(f * 4, f * 2 // factor, bilinear)
        self.up4 = Up(f * 2, f, bilinear)
        self.outc = OutConv(f, n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.inc(_prepare(x, self.dtype))
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        y = self.up1(x5, x4)
        y = self.up2(y, x3)
        y = self.up3(y, x2)
        y = self.up4(y, x1)
        return self.outc(y).float()


class AttentionUNet(_ParamCount, nn.Module):
    """Attention U-Net with optional deep-supervision heads.
    ``use_fused_gate`` routes the eval-mode gates through the fused
    kernel (``ops/attention_gate.py``)."""

    def __init__(self, n_channels: int = 1, n_classes: int = 2,
                 bilinear: bool = True, base_features: int = 64,
                 deep_supervision: bool = False,
                 dtype: torch.dtype = torch.float32,
                 use_fused_gate: Optional[bool] = None):
        super().__init__()
        self.n_channels, self.n_classes = n_channels, n_classes
        self.bilinear, self.dtype = bilinear, dtype
        f = base_features
        factor = 2 if bilinear else 1
        self.inc = DoubleConv(n_channels, f)
        self.down1 = Down(f, f * 2)
        self.down2 = Down(f * 2, f * 4)
        self.down3 = Down(f * 4, f * 8)
        self.down4 = Down(f * 8, f * 16 // factor)
        fg = use_fused_gate
        self.up1 = AttentionUp(f * 16, f * 8 // factor, bilinear, fg)
        self.up2 = AttentionUp(f * 8, f * 4 // factor, bilinear, fg)
        self.up3 = AttentionUp(f * 4, f * 2 // factor, bilinear, fg)
        self.up4 = AttentionUp(f * 2, f, bilinear, fg)
        self.outc = OutConv(f, n_classes)
        self.deep_supervision = deep_supervision
        if deep_supervision:
            # in the parameter tree in eval mode too, so checkpoints match
            self.ds_out3 = OutConv(f * 8 // factor, n_classes)
            self.ds_out2 = OutConv(f * 4 // factor, n_classes)
            self.ds_out1 = OutConv(f * 2 // factor, n_classes)

    def forward(self, x: torch.Tensor):
        x1 = self.inc(_prepare(x, self.dtype))
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        d4 = self.up1(x5, x4)
        d3 = self.up2(d4, x3)
        d2 = self.up3(d3, x2)
        d1 = self.up4(d2, x1)
        logits = self.outc(d1).float()
        if not (self.deep_supervision and self.training):
            return logits
        h, w = x.shape[2], x.shape[3]
        up = lambda t: resize_bilinear_align_corners(t.float(), h, w)
        return (logits, up(self.ds_out1(d2)), up(self.ds_out2(d3)),
                up(self.ds_out3(d4)))
