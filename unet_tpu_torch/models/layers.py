"""U-Net building blocks as PyTorch modules.

Counterpart of ``unet_tpu/models/layers.py``. Tensors are NCHW in
``torch.channels_last`` memory. Parameters and BatchNorm buffers stay
float32; convolutions and the BatchNorm arithmetic run in the input's
dtype (the model's compute dtype), as flax's ``dtype=`` does. Attribute
names are the reference torch project's, so its ``.pt`` state dicts load
with a strict ``load_state_dict`` (mapping: ``utils/torch_port.py``).

Blocks:
  DoubleConv     (Conv3x3 no-bias -> BN -> ReLU) x2
  Down           MaxPool2 -> DoubleConv
  Up             upsample/pad/concat[skip, up]/DoubleConv
  OutConv        1x1 conv with bias
  AttentionGate  additive attention; fused CUDA kernel in eval
  AttentionUp    gate the skip, then Up

In training mode BatchNorm normalizes with the batch statistics and
updates its running statistics (torch semantics); inside a process
group of several ranks those are the global batch's, as the JAX
package's GSPMD reductions give them. The attention
gate upsamples W_g's output before its BatchNorm, as the reference does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from unet_tpu_torch.core.distributed import all_reduce_sum, is_distributed
from unet_tpu_torch.ops.attention_gate import (GateBand,
                                               attention_gate_fused,
                                               fold_bn_into_conv,
                                               fused_shapes_supported)
from unet_tpu_torch.ops.pool import max_pool
from unet_tpu_torch.ops.resize import (pad_to_match,
                                       resize_bilinear_align_corners,
                                       upsample2x_align_corners)

_BN_EPS = 1e-5
_BN_MOMENTUM = 0.9  # old-stat fraction (torch's momentum 0.1 is the new one)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose float32 parameters are cast to the input's
    dtype at each call."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` (no output padding) whose float32
    parameters are cast to the input's dtype at each call."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight.to(x.dtype),
                                  self.bias.to(x.dtype), self.stride,
                                  self.padding, self.output_padding,
                                  self.groups, self.dilation)


class TorchBatchNorm(nn.Module):
    """BatchNorm2d with torch's semantics and the JAX package's rounding:
    the multiplier ``scale * rsqrt(var + eps)`` is formed in float32 and
    cast, then ``(x - mean) * mul + bias`` runs in the input's dtype
    (cuDNN's BatchNorm would keep bf16 inputs in float32). State-dict
    names are ``nn.BatchNorm2d``'s.

    Training mode normalizes with the BIASED batch variance and moves the
    running variance toward the UNBIASED one (factor n/(n-1)), both at
    momentum 0.1. Mean and ``E[x^2] - E[x]^2`` (clamped at 0) are taken
    in float32 whatever the input's dtype, as the JAX package's
    ``TorchBatchNorm`` does; gradients flow through the batch
    statistics.

    Inside a process group of several ranks, training mode sums the
    per-channel ``sum x``, ``sum x^2`` and count over the ranks (one
    float32 all-reduce, differentiable), so the mean, the variance and
    the factor n/(n-1) are the global batch's."""

    def __init__(self, num_features: int, eps: float = _BN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))
        self.register_buffer('num_batches_tracked',
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        if self.training:
            xf = x.float()
            n = x.numel() // x.shape[1]
            if is_distributed():
                c = x.shape[1]
                stats = all_reduce_sum(torch.cat([
                    xf.sum((0, 2, 3)), torch.square(xf).sum((0, 2, 3)),
                    xf.new_full((1,), float(n))]))
                n = stats[2 * c].detach()
                mean = stats[:c] / n
                var = torch.clamp(stats[c:2 * c] / n - torch.square(mean),
                                  min=0.0)
                unbias = n / torch.clamp(n - 1, min=1)
            else:
                mean = xf.mean((0, 2, 3))
                var = torch.clamp(torch.square(xf).mean((0, 2, 3))
                                  - torch.square(mean), min=0.0)
                unbias = n / max(n - 1, 1)
            with torch.no_grad():
                m = _BN_MOMENTUM
                self.running_mean.copy_(m * self.running_mean
                                        + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var
                                       + (1.0 - m) * var * unbias)
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        mul = (self.weight * torch.rsqrt(var + self.eps)).to(dt)
        return ((x - mean.to(dt).view(1, -1, 1, 1))
                * mul.view(1, -1, 1, 1) + self.bias.to(dt).view(1, -1, 1, 1))


class DoubleConv(nn.Module):
    """(Conv3x3 no-bias -> BN -> ReLU) x 2. Takes a tensor or a
    ``(skip, up)`` pair, concatenated in that order."""

    def __init__(self, in_channels: int, out_channels: int,
                 mid_channels: Optional[int] = None):
        super().__init__()
        mid = mid_channels if mid_channels is not None else out_channels
        self.double_conv = nn.Sequential(
            Conv2d(in_channels, mid, 3, padding=1, bias=False),
            TorchBatchNorm(mid),
            nn.ReLU(inplace=True),
            Conv2d(mid, out_channels, 3, padding=1, bias=False),
            TorchBatchNorm(out_channels),
            nn.ReLU(inplace=True))

    def forward(self, x) -> torch.Tensor:
        if isinstance(x, (tuple, list)):
            x = torch.cat(x, dim=1)
        return self.double_conv(x)


class MaxPool(nn.Module):
    """``ops.pool.max_pool`` as a module (2x2, stride 2)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool(x)


class Down(nn.Module):
    """MaxPool(2) -> DoubleConv."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.maxpool_conv = nn.Sequential(
            MaxPool(), DoubleConv(in_channels, out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.maxpool_conv(x)


class OutConv(nn.Module):
    """1x1 conv (with bias) to class logits."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


def _upsample(up: Optional[nn.Module], x1: torch.Tensor) -> torch.Tensor:
    return upsample2x_align_corners(x1) if up is None else up(x1)


class Up(nn.Module):
    """Upsample the decoder map, pad it to the skip's size, concat
    [skip, up], DoubleConv. Bilinear: mid = in_channels // 2; transposed:
    a 2x2/s2 ConvTranspose halves the channels first."""

    def __init__(self, in_channels: int, out_channels: int,
                 bilinear: bool = True):
        super().__init__()
        if bilinear:
            self.up = None
            self.conv = DoubleConv(in_channels, out_channels,
                                   in_channels // 2)
        else:
            self.up = ConvTranspose2d(in_channels, in_channels // 2, 2,
                                      stride=2)
            self.conv = DoubleConv(in_channels, out_channels)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        x1 = pad_to_match(_upsample(self.up, x1), x2.shape[2], x2.shape[3])
        return self.conv((x2, x1))


class _PsiReduce(Conv2d):
    """The gate's psi: a bias-free 1x1 conv to one channel."""

    def __init__(self, channels: int):
        super().__init__(channels, 1, 1, bias=False)


def _fold(conv: Conv2d, bn: TorchBatchNorm):
    k = conv.weight.reshape(conv.out_channels, conv.in_channels).t()
    return fold_bn_into_conv(k, bn.weight, bn.bias, bn.running_mean,
                             bn.running_var, bn.eps)


class AttentionGate(nn.Module):
    """Additive attention gate (Oktay et al.):
    x * sigmoid(BN(psi(relu(BN(W_g g_up) + BN(W_x x))))), where g is
    bilinearly (align-corners) upsampled to x's size. All 1x1 convs are
    bias-free.

    ``use_fused`` takes the fused gate in eval mode wherever
    ``fused_shapes_supported`` holds: BatchNorm is folded from the
    running stats and ``attention_gate_fused`` runs the CUDA kernel (its
    plain version for CPU tensors). Otherwise, in eval, W_g and its BN
    run at low resolution and the result is upsampled (exact in eval:
    both are per-pixel affine maps, which commute with the
    interpolation). In training the batch statistics must come from the
    upsampled map, so W_g runs at low resolution (linear, so exact), the
    result is upsampled, and then its BN runs.
    """

    def __init__(self, gate_channels: int, skip_channels: int,
                 inter_channels: int, use_fused: Optional[bool] = None):
        super().__init__()
        self.use_fused = bool(use_fused)
        self.W_g = nn.Sequential(
            Conv2d(gate_channels, inter_channels, 1, bias=False),
            TorchBatchNorm(inter_channels))
        self.W_x = nn.Sequential(
            Conv2d(skip_channels, inter_channels, 1, bias=False),
            TorchBatchNorm(inter_channels))
        self.psi = nn.Sequential(_PsiReduce(inter_channels),
                                 TorchBatchNorm(1))

    def takes_fused(self, g_shape, x_shape) -> bool:
        """Whether the gate of g and x of these (whole-map) shapes runs
        fused."""
        return (self.use_fused and not self.training
                and fused_shapes_supported(g_shape, x_shape))

    def forward(self, g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        if self.takes_fused(g.shape, x.shape):
            return self.fused(g, x)
        h, w = x.shape[2], x.shape[3]
        if self.training:
            conv, bn = self.W_g
            g1 = bn(resize_bilinear_align_corners(conv(g), h, w))
        else:
            g1 = resize_bilinear_align_corners(self.W_g(g), h, w)
        a = torch.sigmoid(self.psi(torch.relu(g1 + self.W_x(x))))
        return x * a.to(x.dtype)

    def fused(self, g: torch.Tensor, x: torch.Tensor,
              band: Optional[GateBand] = None) -> torch.Tensor:
        """The gate through ``attention_gate_fused`` with BatchNorm folded
        from the running stats; ``band`` places x and g in the whole map
        (see ``GateBand``)."""
        dt = x.dtype
        kg, bg = _fold(*self.W_g)
        kx, bx = _fold(*self.W_x)
        kp, bp = _fold(*self.psi)
        cl = torch.channels_last
        return attention_gate_fused(
            g.contiguous(memory_format=cl), x.contiguous(memory_format=cl),
            kg.to(dt).contiguous(), kx.to(dt).contiguous(),
            (bg + bx).float(), kp.to(dt).contiguous(), bp.float(), band)


class AttentionUp(nn.Module):
    """AttentionGate on the skip (gated by the un-upsampled decoder
    map), then Up-style upsample/pad/concat/DoubleConv."""

    def __init__(self, in_channels: int, out_channels: int,
                 bilinear: bool = True,
                 use_fused_gate: Optional[bool] = None):
        super().__init__()
        skip = in_channels // 2
        gate = skip if bilinear else in_channels
        self.attention = AttentionGate(gate, skip, skip // 2,
                                       use_fused=use_fused_gate)
        if bilinear:
            self.up = None
            self.conv = DoubleConv(in_channels, out_channels, skip)
        else:
            self.up = ConvTranspose2d(in_channels, skip, 2, stride=2)
            self.conv = DoubleConv(in_channels, out_channels)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        x2_att = self.attention(x1, x2)
        x1 = pad_to_match(_upsample(self.up, x1), x2_att.shape[2],
                          x2_att.shape[3])
        return self.conv((x2_att, x1))
