"""Fused eval-mode attention gate: CUDA kernel wrapper and plain version.

Counterpart of ``unet_tpu/ops/pallas/attention_gate.py``. With
BatchNorm folded into the 1x1 convs the gate is

    g_up = bilinear_align_corners(g, size(x))
    t    = relu(g_up @ wg + x @ wx + badd)
    att  = sigmoid(t @ wpsi + bpsi)
    out  = x * att

``attention_gate_fused`` launches the hand-written kernel
(``unet_tpu_torch/csrc/attention_gate.cu``) on CUDA tensors and takes
the plain PyTorch version, ``attention_gate_reference``, only for
tensors on the CPU. Tensors are NCHW; the kernel wants g and x in
``torch.channels_last`` memory so each pixel's channels are contiguous.
In bfloat16 the kernel runs on the tensor cores and takes exactly 2x
upsampling (so every shape the model's guard, ``fused_shapes_supported``,
admits): its TMA loads want 16-byte rows, so the wrapper pads Cg, Cx and
I with zeros to multiples of 8 before the launch, which is exact. The
float32 kernel takes any shape.

With ``band`` (a ``GateBand``) x holds a band of rows of a larger map and
g the rows of the whole source that the band reads: the kernel computes
the band's rows of the whole map's gate on the global row coordinates,
bit for bit as the whole map's launch computes them. The height-sharded
forward (``core/spatial.py``) gates each band so.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from unet_tpu_torch.ops.resize import (resize_bilinear_align_corners,
                                       resize_rows_align_corners,
                                       source_rows)

# Kernel launches since the count was last reset (chip_smoke.py resets
# it before driving the main path and reads it after).
launch_count = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class GateBand(NamedTuple):
    """Where the gate's operands lie in the whole map: x holds rows
    [y_off, y_off + x rows) of a map ``h_out_full`` rows high, g rows
    [g_off, g_off + g rows) of the source, ``h_in_full`` rows high."""
    y_off: int
    g_off: int
    h_in_full: int
    h_out_full: int


def fold_bn_into_conv(kernel: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, mean: torch.Tensor,
                      var: torch.Tensor, eps: float = 1e-5
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold inference BatchNorm into a bias-free 1x1 conv.

    y = scale*(x@W - mean)/sqrt(var+eps) + bias = x @ (W*a) + (bias - mean*a)
    where a = scale/sqrt(var+eps). kernel is (Cin, Cout)."""
    a = scale * torch.rsqrt(var + eps)
    return kernel * a[None, :], bias - mean * a


def fused_shapes_supported(g_shape, x_shape) -> bool:
    """Where the model takes the fused gate: the same rule as the JAX
    package's (exactly 2x per axis, low-res side >= 16, the spatial
    sizes multiples of 8), so both launch the kernel on the same gates.
    Shapes are NCHW."""
    _, _, h_in, w_in = g_shape
    _, _, h_out, w_out = x_shape
    return (min(h_in, w_in) >= 16 and h_out % 8 == 0
            and w_out % 8 == 0 and w_in % 8 == 0
            and h_out == 2 * h_in and w_out == 2 * w_in)


def attention_gate_reference(g: torch.Tensor, x: torch.Tensor,
                             wg: torch.Tensor, wx: torch.Tensor,
                             badd: torch.Tensor, wpsi: torch.Tensor,
                             bpsi: Union[float, torch.Tensor],
                             band: Optional[GateBand] = None
                             ) -> torch.Tensor:
    """Plain PyTorch version of the folded gate, step for step as the
    JAX package's ``attention_gate_reference``. g (N, Cg, h, w),
    x (N, Cx, H, W), wg (Cg, I), wx (Cx, I), badd (I,), wpsi (I, 1);
    with ``band``, the band's rows of the whole map's gate."""
    dt = x.dtype
    if band is None:
        g_up = resize_bilinear_align_corners(g, x.shape[2], x.shape[3])
    else:
        g_up = resize_rows_align_corners(
            g, band.g_off, band.h_in_full, band.h_out_full, x.shape[3],
            band.y_off, band.y_off + x.shape[2])
    t = torch.relu(
        torch.einsum('nchw,ci->nihw', g_up, wg.to(dt))
        + torch.einsum('nchw,ci->nihw', x, wx.to(dt))
        + badd.float().to(dt)[None, :, None, None])
    p = torch.einsum('nihw,io->nohw', t, wpsi.reshape(-1, 1).to(dt))
    return x * torch.sigmoid(p.float() + bpsi).to(dt)


def _lib() -> ctypes.CDLL:
    from unet_tpu_torch.ops import _build
    lib = _build.load('attention_gate')
    if lib.attention_gate_launch.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.attention_gate_launch.argtypes = (
            [i32] + [ptr] * 8 + [i32] * 12 + [f32, f32, ptr])
        lib.attention_gate_launch.restype = ctypes.c_int
        lib.attention_gate_error_string.argtypes = [i32]
        lib.attention_gate_error_string.restype = ctypes.c_char_p
    return lib


def _align_scale(n_in: int, n_out: int) -> float:
    """src = i * (in-1)/(out-1), the ratio rounded to f32 as the TPU
    kernel rounds it."""
    return float(np.float32((n_in - 1) / (n_out - 1))) if n_out > 1 else 0.0


def _pad_dim(t: torch.Tensor, dim: int) -> torch.Tensor:
    """t with zeros appended along dim up to a multiple of 8."""
    pad = -t.shape[dim] % 8
    if not pad:
        return t
    widths = [0, 0] * (t.dim() - 1 - dim) + [0, pad]
    return F.pad(t, widths)


def _pad_for_tma(g, x, wg, wx, badd, wpsi):
    """Cg, Cx and I padded with zeros to multiples of 8, as the bfloat16
    kernel's TMA loads want every row 16-byte aligned. Exact: a zero
    channel of g or x meets a zero row of wg or wx and adds nothing to t
    (the kernel walks K in chunks of 64 channels whose tail TMA fills
    with zeros in just this way); a zero column of wg and wx with a zero
    of badd gives t = relu(0) = 0 there, times a zero of wpsi. The
    caller drops the padded channels of the output. What is a multiple
    of 8 already is passed through as it is."""
    cl = torch.channels_last
    g, x = (_pad_dim(t, 1).contiguous(memory_format=cl) for t in (g, x))
    wg, wx = (_pad_dim(_pad_dim(t, 0), 1) for t in (wg, wx))
    return (g, x, wg, wx, _pad_dim(badd, 0),
            _pad_dim(wpsi.reshape(-1, 1), 0))


def _check(g, x, wg, wx, badd, wpsi, bpsi,
           band: Optional[GateBand] = None) -> None:
    if band is None:
        band = GateBand(0, 0, g.shape[2], x.shape[2])
    if x.dtype not in _DTYPES:
        raise TypeError(f'attention gate kernel: unsupported dtype {x.dtype}')
    if g.dim() != 4 or x.dim() != 4 or g.shape[0] != x.shape[0]:
        raise ValueError(f'attention gate kernel: g {tuple(g.shape)} and '
                         f'x {tuple(x.shape)} must be (N, C, H, W)')
    cg, cx, inter = g.shape[1], x.shape[1], wg.shape[-1]
    want = {'g': (g, x.dtype, None), 'wg': (wg, x.dtype, (cg, inter)),
            'wx': (wx, x.dtype, (cx, inter)),
            'wpsi': (wpsi, x.dtype, None),
            'badd': (badd, torch.float32, (inter,)),
            'bpsi': (bpsi, torch.float32, None)}
    for name, (t, dtype, shape) in want.items():
        if t.device != x.device:
            raise ValueError(f'attention gate kernel: {name} on {t.device}, '
                             f'x on {x.device}')
        if t.dtype != dtype:
            raise TypeError(f'attention gate kernel: {name} is {t.dtype}, '
                            f'needs {dtype}')
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f'attention gate kernel: {name} has shape '
                             f'{tuple(t.shape)}, needs {shape}')
    if x.dtype == torch.bfloat16 and (band.h_out_full != 2 * band.h_in_full
                                      or x.shape[3] != 2 * g.shape[3]):
        raise ValueError(
            f'attention gate kernel: the bfloat16 kernel takes exactly 2x '
            f'upsampling, not g {tuple(g.shape)}, x {tuple(x.shape)} of '
            f'{band}')
    if (band.y_off < 0 or band.y_off + x.shape[2] > band.h_out_full
            or band.g_off < 0 or band.g_off + g.shape[2] > band.h_in_full):
        raise ValueError(f'attention gate kernel: g {tuple(g.shape)} and x '
                         f'{tuple(x.shape)} do not lie in {band}')
    lo, hi = ((0, 0) if x.shape[2] == band.h_out_full  # the whole map
              else source_rows(band.h_in_full, band.h_out_full, band.y_off,
                               band.y_off + x.shape[2]))
    if lo < band.g_off or hi > band.g_off + g.shape[2]:
        raise ValueError(f'attention gate kernel: x rows of {band} read g '
                         f'rows [{lo}, {hi}), g holds {g.shape[2]} from '
                         f'{band.g_off}')
    if wpsi.numel() != inter or bpsi.numel() != 1:
        raise ValueError('attention gate kernel: wpsi needs I elements and '
                         'bpsi one')
    for name, t in (('g', g), ('x', x)):
        if not t.is_contiguous(memory_format=torch.channels_last):
            raise ValueError(f'attention gate kernel: {name} must be '
                             'contiguous in torch.channels_last')
    for name, t in (('wg', wg), ('wx', wx), ('wpsi', wpsi), ('badd', badd)):
        if not t.is_contiguous():
            raise ValueError(f'attention gate kernel: {name} must be '
                             'contiguous')
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f'attention gate kernel: x is on {x.device}, the '
                         f'current device is {torch.cuda.current_device()}')


def attention_gate_fused(g: torch.Tensor, x: torch.Tensor,
                         wg: torch.Tensor, wx: torch.Tensor,
                         badd: torch.Tensor, wpsi: torch.Tensor,
                         bpsi: Union[float, torch.Tensor],
                         band: Optional[GateBand] = None) -> torch.Tensor:
    """Fused inference attention gate.

    Args:
      g: gating features (N, Cg, h, w), the decoder's lower resolution
      x: skip features (N, Cx, H, W)
      wg: folded W_g (Cg, I); wx: folded W_x (Cx, I), both in x's dtype
      badd: summed folded biases (I,) float32
      wpsi: folded psi weights (I, 1) in x's dtype; bpsi: folded psi bias
        (a float or a one-element float32 tensor)
      band: where x and g lie in the whole map (None: they are whole)
    Returns x * sigmoid(psi(relu(Wg g_up + Wx x))), shaped like x.

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes
    ``attention_gate_reference``.
    """
    global launch_count
    if x.device.type == 'cpu':
        return attention_gate_reference(g, x, wg, wx, badd, wpsi, bpsi,
                                        band)
    if x.device.type != 'cuda':
        raise ValueError(f'attention gate kernel: no kernel for {x.device}')
    if not torch.is_tensor(bpsi):
        bpsi = torch.tensor([float(bpsi)], device=x.device)
    if band is None:
        band = GateBand(0, 0, g.shape[2], x.shape[2])
    _check(g, x, wg, wx, badd, wpsi, bpsi, band)
    cx = x.shape[1]
    if x.dtype == torch.bfloat16:
        g, x, wg, wx, badd, wpsi = _pad_for_tma(g, x, wg, wx, badd, wpsi)
    n, cg, h_in, w_in = g.shape
    _, _, h_out, w_out = x.shape
    out = torch.empty_like(x, memory_format=torch.channels_last)
    lib = _lib()
    err = lib.attention_gate_launch(
        _DTYPES[x.dtype], g.data_ptr(), x.data_ptr(), wg.data_ptr(),
        wx.data_ptr(), badd.data_ptr(), wpsi.data_ptr(), bpsi.data_ptr(),
        out.data_ptr(), n, h_in, w_in, h_out, w_out, cg, x.shape[1],
        wg.shape[1], band.y_off, band.g_off, band.h_in_full,
        band.h_out_full, _align_scale(band.h_in_full, band.h_out_full),
        _align_scale(w_in, w_out),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError('attention gate kernel launch failed: '
                           + lib.attention_gate_error_string(err).decode())
    launch_count += 1
    if out.shape[1] != cx:
        out = out[:, :cx].contiguous(memory_format=torch.channels_last)
    return out
