"""UNet (Ronneberger et al., arXiv:1505.04597) and Attention U-Net
(Oktay et al., arXiv:1804.03999), bilinear decoders, in plain PyTorch.

Parameter names are those of the reference torch project, so one state
dict loads into this model and into the program. Each block follows the
published equations: DoubleConv = (3x3 conv without bias, BatchNorm,
ReLU) twice; Down = 2x2 max pool, DoubleConv; Up = bilinear 2x
align-corners upsample, zero pad to the skip, concat [skip, up],
DoubleConv with mid = in/2; the gate x * sigmoid(BN(psi(relu(BN(W_g
up(g)) + BN(W_x x))))) with bias-free 1x1 convs and g upsampled to x's
size first; a 1x1 head with bias. BatchNorm is ``nn.BatchNorm2d``
(momentum 0.1, eps 1e-5, biased variance to normalise, unbiased to
track). Everything runs in float32.

``set_fp8(model, True)`` rounds every convolution's input and weights
to float8 e4m3 (one scale per tensor, from its largest magnitude;
gradients pass straight through): the control that computes in the
precision below the configuration's bfloat16.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8 e4m3fn


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, as float32;
    the gradient passes straight through."""
    amax = x.detach().abs().amax().clamp(min=1e-12)
    s = FP8_MAX / amax
    q = (x.detach() * s).to(torch.float8_e4m3fn).to(x.dtype) / s
    return x + (q - x.detach())


class Conv(nn.Conv2d):
    fp8 = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return super().forward(x)
        return self._conv_forward(fp8_round(x), fp8_round(self.weight),
                                  self.bias)


def set_fp8(model: nn.Module, on: bool) -> None:
    for m in model.modules():
        if isinstance(m, Conv):
            m.fp8 = on


class DoubleConv(nn.Module):
    def __init__(self, cin: int, cout: int, mid: int = None):
        super().__init__()
        mid = cout if mid is None else mid
        self.double_conv = nn.Sequential(
            Conv(cin, mid, 3, padding=1, bias=False), nn.BatchNorm2d(mid),
            nn.ReLU(), Conv(mid, cout, 3, padding=1, bias=False),
            nn.BatchNorm2d(cout), nn.ReLU())

    def forward(self, x):
        return self.double_conv(x)


class _Pool(nn.Module):
    def forward(self, x):
        return F.max_pool2d(x, 2)


class Down(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.maxpool_conv = nn.Sequential(_Pool(), DoubleConv(cin, cout))

    def forward(self, x):
        return self.maxpool_conv(x)


def _up_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    if x.shape[-2:] == (h, w):
        return x
    return F.interpolate(x, size=(h, w), mode='bilinear',
                         align_corners=True)


def _join(skip: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
    """Upsample ``low`` 2x, pad it to the skip's size, concat [skip, up]."""
    up = _up_to(low, 2 * low.shape[2], 2 * low.shape[3])
    dh, dw = skip.shape[2] - up.shape[2], skip.shape[3] - up.shape[3]
    up = F.pad(up, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
    return torch.cat([skip, up], dim=1)


class Up(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = DoubleConv(cin, cout, cin // 2)

    def forward(self, low, skip):
        return self.conv(_join(skip, low))


class AttentionGate(nn.Module):
    def __init__(self, cg: int, cx: int, inter: int):
        super().__init__()
        self.W_g = nn.Sequential(Conv(cg, inter, 1, bias=False),
                                 nn.BatchNorm2d(inter))
        self.W_x = nn.Sequential(Conv(cx, inter, 1, bias=False),
                                 nn.BatchNorm2d(inter))
        self.psi = nn.Sequential(Conv(inter, 1, 1, bias=False),
                                 nn.BatchNorm2d(1))

    def forward(self, g, x):
        g_up = _up_to(g, x.shape[2], x.shape[3])
        a = torch.relu(self.W_g(g_up) + self.W_x(x))
        return x * torch.sigmoid(self.psi(a))


class AttentionUp(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        skip = cin // 2
        self.attention = AttentionGate(skip, skip, skip // 2)
        self.conv = DoubleConv(cin, cout, skip)

    def forward(self, low, skip):
        return self.conv(_join(self.attention(low, skip), low))


class OutConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Conv(cin, cout, 1)

    def forward(self, x):
        return self.conv(x)


class Net(nn.Module):
    """UNet or AttentionUNet (bilinear) of the given widths."""

    def __init__(self, model: Dict):
        super().__init__()
        if not model['bilinear'] or model.get('deep_supervision'):
            raise ValueError('the reference holds bilinear networks '
                             'without deep supervision')
        f = int(model['base_features'])
        attention = model['type'] == 'attention_unet'
        up = AttentionUp if attention else Up
        self.inc = DoubleConv(int(model['n_channels']), f)
        self.down1 = Down(f, 2 * f)
        self.down2 = Down(2 * f, 4 * f)
        self.down3 = Down(4 * f, 8 * f)
        self.down4 = Down(8 * f, 8 * f)
        self.up1 = up(16 * f, 4 * f)
        self.up2 = up(8 * f, 2 * f)
        self.up3 = up(4 * f, f)
        self.up4 = up(2 * f, f)
        self.outc = OutConv(f, int(model['n_classes']))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        y = self.up1(x5, x4)
        y = self.up2(y, x3)
        y = self.up3(y, x2)
        y = self.up4(y, x1)
        return self.outc(y)
