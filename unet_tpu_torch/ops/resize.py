"""Resize ops with ``align_corners=True`` semantics on NCHW tensors.

Counterpart of ``unet_tpu/ops/resize.py``, which writes the align-corners
lerp as gather tables (or MXU matmuls on a TPU) for XLA: no TPU kernel.
``resize_bilinear_align_corners`` (and ``upsample2x_align_corners``)
takes a CUDA tensor through the hand-written kernel pair
(``unet_tpu_torch/csrc/resize.cu``; an upsample of a channels_last map,
bf16 or float32) as one ``torch.autograd.Function`` (``ResizeFn``) of
one launch each way, or raises (``check_kernel_args``); a CPU tensor
keeps ATen's ``F.interpolate`` (``interpolate_align_corners``). Both
implement the coordinate map ``src = i * (in - 1) / (out - 1)`` with
ATen's float32 rounding (``_taps``).

``PlainOps`` is the kernels' arithmetic in plain PyTorch: the forward's
lerps (``resize_rows_align_corners``) and the backward as a gather, each
input index summing the outputs whose taps reach it (``contributors``,
the kernel's own rule, which the CPU tests hold exhaustively).

``resize_rows_align_corners`` is the band form the height-sharded
forward (``core/spatial.py``) needs: a band of output rows from the
source rows it reads, on the global coordinates.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from unet_tpu_torch.ops import _build
from unet_tpu_torch.ops.batch_norm import check_map

# Kernel launches of one call, forward and backward.
LAUNCHES_PER_CALL = 2

_CL = torch.channels_last
_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
KERNELS = _build.Kernels('resize', 'rs_error_string', {
    'rs_forward': ([_P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P, _P], 1),
    'rs_backward': ([_P, _LL, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P, _P],
                    1)})


def interpolate_align_corners(x: torch.Tensor, out_h: int,
                              out_w: int) -> torch.Tensor:
    """ATen's bilinear align-corners resize (``F.interpolate``): the route
    of CPU tensors, and of the fused gate's plain version."""
    return F.interpolate(x, size=(out_h, out_w), mode='bilinear',
                         align_corners=True)


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int,
                                  out_w: int) -> torch.Tensor:
    """Bilinear align-corners resize of an (N, C, H, W) tensor: through the
    kernels for a CUDA tensor (or a raise, as ``check_kernel_args`` says),
    through ``F.interpolate`` for a CPU tensor."""
    if x.shape[-2:] == (out_h, out_w):
        return x
    if x.is_cuda:
        check_kernel_args(x, out_h, out_w)
        return ResizeFn.apply(
            x, out_h, out_w,
            KernelOps(torch.cuda.current_stream().cuda_stream))
    return interpolate_align_corners(x, out_h, out_w)


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


@functools.lru_cache(maxsize=None)
def _scale(in_size: int, out_size: int) -> float:
    """ATen's align-corners scale, ``f32(in - 1) / f32(out - 1)`` (0 for
    one output), as a float that float32 holds exactly."""
    if out_size <= 1:
        return 0.0
    return float(np.float32(in_size - 1) / np.float32(out_size - 1))


def _taps(in_size: int, out_size: int, start: int, stop: int,
          device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ATen's align-corners taps of output indices [start, stop): the
    lower source index, its neighbour (itself at the last index) and the
    float32 weight of the neighbour, ``src = i * ((in - 1) / (out - 1))``
    with the scale rounded to float32 first, as ATen computes it. Built
    on ``device`` from host scalars, so the host never waits on it."""
    src = torch.arange(start, stop, dtype=torch.float32,
                       device=device) * _scale(in_size, out_size)
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


# ----------------------------------------------- the kernels' index rule

def _tap(i: int, in_size: int, out_size: int) -> Tuple[int, int, np.float32]:
    """One output index's taps (lo, hi, w), in float32 as ``_taps``."""
    src = np.float32(i) * np.float32(_scale(in_size, out_size))
    lo = min(int(src), in_size - 1)
    hi = lo + 1 if lo < in_size - 1 else lo
    return lo, hi, np.float32(src - np.float32(lo))


def first_reaching(k: int, in_size: int, out_size: int) -> int:
    """The first output index whose lower tap is at least ``k`` (0 for
    k <= 0, ``out_size`` beyond the last input index): found as the
    kernel finds it, from ``k / scale`` stepped to the exact index."""
    if k <= 0:
        return 0
    if k > in_size - 1:
        return out_size
    scale = np.float32(_scale(in_size, out_size))
    i = min(max(0, int(np.float32(k) / scale) - 2), out_size)
    while i > 0 and _tap(i - 1, in_size, out_size)[0] >= k:
        i -= 1
    while i < out_size and _tap(i, in_size, out_size)[0] < k:
        i += 1
    return i


def contributors(j: int, in_size: int, out_size: int) -> range:
    """The output indices whose taps reach input index ``j`` of an
    upsample: those with lo in {j - 1, j}, a range since lo never
    decreases and steps by at most 1."""
    return range(first_reaching(j - 1, in_size, out_size),
                 first_reaching(j + 1, in_size, out_size))


def adjoint_weight(i: int, j: int, in_size: int,
                   out_size: int) -> np.float32:
    """The weight output ``i`` gives input ``j`` (one of its taps) in the
    backward: 1 - w at lo, w at hi, (1 - w) + w where both are j."""
    lo, hi, w = _tap(i, in_size, out_size)
    if lo != j:
        return w
    w0 = np.float32(1.0) - w
    return np.float32(w0 + w) if hi == j else w0


@functools.lru_cache(maxsize=16)
def gather_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32: row j holds ``adjoint_weight`` at
    ``contributors(j)`` and 0 elsewhere."""
    m = np.zeros((in_size, out_size), np.float32)
    for j in range(in_size):
        for i in contributors(j, in_size, out_size):
            m[j, i] = adjoint_weight(i, j, in_size, out_size)
    return m


def check_kernel_args(x: torch.Tensor, out_h: int, out_w: int) -> None:
    """Raise unless the kernels take this resize: x as
    ``batch_norm.check_map`` says (bf16 or float32, 4-D, contiguous in
    channels_last, on the current CUDA device; not a channel slice, whose
    pixels lie further apart than its channels) and an output at least as
    large as x in each dimension."""
    h, w = x.shape[-2:]
    if out_h < h or out_w < w:
        raise ValueError(f'resize: {h}x{w} -> {out_h}x{out_w} shrinks a '
                         'dimension; the kernels take upsamples only')
    p = pixel_stride(x) if x.dim() == 4 else None
    if p is not None and p != x.shape[1]:
        raise ValueError(f'resize: x\'s pixels lie {p} elements apart for '
                         f'{x.shape[1]} channels; the forward reads dense '
                         'channels_last maps')
    check_map('resize', x)


def pixel_stride(t: torch.Tensor):
    """The distance in elements between neighbouring pixels of ``t`` (N,
    C, H, W) if it lies as channels_last pixels that far apart (a channel
    slice of a wider channels_last tensor among them), else None."""
    n, c, h, w = t.shape
    p = t.stride(3) if w > 1 else c
    want = (h * w * p, 1, w * p, p)
    if p < c or any(size > 1 and s != ws for size, s, ws in
                    zip(t.shape, t.stride(), want)):
        return None
    return p


class PlainOps:
    """The kernels' arithmetic in plain PyTorch, in float32: the forward's
    lerps and the backward as ``gather_matrix`` products."""

    @staticmethod
    def forward(x, out_h, out_w):
        return resize_rows_align_corners(x, 0, x.shape[2], out_h, out_w, 0,
                                         out_h)

    @staticmethod
    def backward(dy, in_h, in_w):
        out_h, out_w = dy.shape[2], dy.shape[3]
        wy, wx = (torch.from_numpy(gather_matrix(i, o)).to(dy.device)
                  for i, o in ((in_h, out_h), (in_w, out_w)))
        dx = torch.einsum('jy,ncyx,kx->ncjk', wy, dy.float(), wx)
        return dx.to(dy.dtype).contiguous(memory_format=_CL)


class KernelOps:
    """The two directions as kernel launches on ``stream`` (a cudaStream_t
    as an int: the forward's, on which autograd also runs the backward);
    the same interface as ``PlainOps``."""

    def __init__(self, stream: int):
        self.stream = stream

    def forward(self, x, out_h, out_w):
        n, c, h, w = x.shape
        y = torch.empty((n, c, out_h, out_w), dtype=x.dtype, device=x.device,
                        memory_format=_CL)
        KERNELS.rs_forward(x.data_ptr(), x.dtype == torch.bfloat16, n, c, h,
                           w, out_h, out_w, _scale(h, out_h),
                           _scale(w, out_w), y.data_ptr(), self.stream)
        return y

    def backward(self, dy, in_h, in_w):
        """dx from dy read where it lies: at its own pixel stride, copied
        only where it does not lie as channels_last pixels."""
        p = pixel_stride(dy)
        if p is None:
            dy = dy.clone(memory_format=_CL)
            p = dy.shape[1]
        n, c, out_h, out_w = dy.shape
        dx = torch.empty((n, c, in_h, in_w), dtype=dy.dtype,
                         device=dy.device, memory_format=_CL)
        KERNELS.rs_backward(dy.data_ptr(), p, dy.dtype == torch.bfloat16, n,
                            c, in_h, in_w, out_h, out_w, _scale(in_h, out_h),
                            _scale(in_w, out_w), dx.data_ptr(), self.stream)
        return dx


class ResizeFn(torch.autograd.Function):
    """``apply(x, out_h, out_w, ops)``: the resize each way through ``ops``
    (a ``KernelOps`` or ``PlainOps``); nothing is saved but x's size."""

    @staticmethod
    def forward(ctx, x, out_h, out_w, ops):
        ctx.in_hw, ctx.ops = (x.shape[2], x.shape[3]), ops
        return ops.forward(x, out_h, out_w)

    @staticmethod
    def backward(ctx, dy):
        return ctx.ops.backward(dy, *ctx.in_hw), None, None, None
