"""3x3 stride-1 SAME convolution as an implicit GEMM: CUDA kernel wrapper
and plain version.

Counterpart of ``unet_tpu/ops/pallas/conv3x3.py``. For x (N, Cin, H, W)
and k (3, 3, Cin, Cout) -- the JAX package's weight layout; a caller
holding an ``nn.Conv2d`` weight passes ``w.permute(2, 3, 1, 0)`` --

    out = relu?(conv3x3(x, k) * mul + add)      (mul/add optional)

with k cast to x's dtype, every product summed in float32 and one
rounding to x's dtype at the end, as the TPU kernel does.

  * ``conv3x3(x, k)``: autograd function; forward and the data gradient
    (the same convolution on the rot180, channel-transposed weights)
    launch the kernel, the weight gradient is the library's
    (``torch.nn.grad.conv2d_weight``), as the JAX package leaves it to
    XLA's conv.
  * ``conv3x3_bn_relu``: the eval epilogue ``relu(acc * mul + add)``
    inside the kernel (``mul, add`` from ``fold_bn_scale_shift``); no
    gradient.
  * ``conv3x3_plain``: the plain PyTorch version of the kernel's
    arithmetic; ``conv3x3_reference``: the library convolution
    (``F.conv2d``), the golden target.

A CUDA tensor launches the hand-written kernel
(``unet_tpu_torch/csrc/conv3x3.cu``) or raises; a CPU tensor takes
``conv3x3_plain``. x must be contiguous in ``torch.channels_last`` on
the card, so it is physically the JAX package's NHWC. The port's
``DoubleConv`` does not call this op, as the JAX package's model does
not call its kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

# Kernel launches (forward and data gradient alike) since the count was
# last reset (chip_smoke.py resets it before driving the path and reads
# it after).
launch_count = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fold_bn_scale_shift(scale: torch.Tensor, bias: torch.Tensor,
                        mean: torch.Tensor, var: torch.Tensor,
                        eps: float = 1e-5
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference BatchNorm as ``y = conv_out * mul + add`` per channel;
    returns float32 ``(mul, add)``."""
    mul = scale.float() * torch.rsqrt(var.float() + eps)
    return mul, bias.float() - mean.float() * mul


def igemm_shapes_supported(x_shape, k_shape, itemsize: int = 2) -> bool:
    """Shapes the kernel takes: a (3, 3, Cin, Cout) kernel whose Cin
    matches x's (N, C, H, W), with Cin and Cout >= 64 and multiples of
    64 -- so the 1 -> 64 stem and the logits heads stay on the library
    conv. Any N, H, W >= 1: the TPU guard's W % 128, H % 8 and VMEM tile
    budget are mechanics of that kernel, so ``itemsize`` (kept for the
    JAX signature) changes nothing, and the data gradient's swapped
    orientation (Cout -> Cin) holds whenever this one does."""
    del itemsize
    if len(k_shape) != 4 or tuple(k_shape[:2]) != (3, 3):
        return False
    if len(x_shape) != 4:
        return False
    n, cin, h, w = x_shape
    cout = k_shape[3]
    if k_shape[2] != cin:
        return False
    if cin < 64 or cout < 64 or cin % 64 or cout % 64:
        return False
    return min(n, h, w) >= 1


def conv3x3_reference(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The library convolution with the same semantics (golden target,
    and the yardstick ``chip_smoke.py`` times beside the kernel)."""
    return F.conv2d(x, k.to(x.dtype).permute(3, 2, 0, 1), padding=1)


def conv3x3_plain(x: torch.Tensor, k: torch.Tensor,
                  mul: Optional[torch.Tensor] = None,
                  add: Optional[torch.Tensor] = None,
                  relu: bool = False) -> torch.Tensor:
    """The kernel's arithmetic step by step: x and k rounded to x's
    dtype, then nine shifted taps, each a float32 product summed in
    float32 (products of bf16 values are exact in f32; nothing is
    rounded to bf16 before the end), then ``acc * mul + add`` in f32,
    ReLU, and one rounding to x's dtype. On the card this needs TF32 off
    (``torch.backends.cuda.matmul.allow_tf32 = False``, the default)."""
    dt = x.dtype
    n, _, h, w = x.shape
    xp = F.pad(x.float(), (1, 1, 1, 1))
    kf = k.to(dt).float()
    acc = None
    for dy in range(3):
        for dx in range(3):
            part = torch.einsum('nchw,co->nohw',
                                xp[:, :, dy:dy + h, dx:dx + w], kf[dy, dx])
            acc = part if acc is None else acc + part
    if mul is not None:
        acc = (acc * mul.float().view(1, -1, 1, 1)
               + add.float().view(1, -1, 1, 1))
    if relu:
        acc = torch.relu(acc)
    return acc.to(dt).contiguous(memory_format=torch.channels_last)


def _lib() -> ctypes.CDLL:
    from unet_tpu_torch.ops import _build
    lib = _build.load('conv3x3')
    if lib.conv3x3_launch.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.conv3x3_launch.argtypes = [i32] + [ptr] * 5 + [i32] * 6 + [ptr]
        lib.conv3x3_launch.restype = ctypes.c_int
        lib.conv3x3_error_string.argtypes = [i32]
        lib.conv3x3_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, k, mul, add) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f'conv3x3 kernel: unsupported dtype {x.dtype}')
    if not igemm_shapes_supported(tuple(x.shape), tuple(k.shape)):
        raise ValueError(f'conv3x3 kernel: x {tuple(x.shape)} with k '
                         f'{tuple(k.shape)} is not a shape the kernel takes '
                         '(igemm_shapes_supported)')
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError('conv3x3 kernel: x must be contiguous in '
                         'torch.channels_last')
    if not k.is_floating_point():
        raise TypeError(f'conv3x3 kernel: k is {k.dtype}')
    if (mul is None) != (add is None):
        raise ValueError('conv3x3 kernel: mul and add go together')
    tensors = {'k': k}
    if mul is not None:
        tensors.update(mul=mul, add=add)
        for name, t in (('mul', mul), ('add', add)):
            if t.dtype != torch.float32:
                raise TypeError(f'conv3x3 kernel: {name} is {t.dtype}, '
                                'needs torch.float32')
            if tuple(t.shape) != (k.shape[3],) or not t.is_contiguous():
                raise ValueError(f'conv3x3 kernel: {name} must be a '
                                 f'contiguous ({k.shape[3]},) vector')
    for name, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f'conv3x3 kernel: {name} on {t.device}, x on '
                             f'{x.device}')
    if x.data_ptr() % 16:
        raise ValueError('conv3x3 kernel: x must be 16-byte aligned')
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f'conv3x3 kernel: x is on {x.device}, the current '
                         f'device is {torch.cuda.current_device()}')


def _conv(x: torch.Tensor, k: torch.Tensor, mul: Optional[torch.Tensor],
          add: Optional[torch.Tensor], relu: bool) -> torch.Tensor:
    """One launch of the kernel (a CUDA tensor) or the plain version (a
    CPU tensor)."""
    global launch_count
    if x.device.type == 'cpu':
        return conv3x3_plain(x, k, mul, add, relu)
    if x.device.type != 'cuda':
        raise ValueError(f'conv3x3 kernel: no kernel for {x.device}')
    _check(x, k, mul, add)
    n, cin, h, w = x.shape
    cout = k.shape[3]
    wk = k.to(x.dtype).contiguous()  # (3, 3, Cin, Cout): row tap*Cin + c
    out = torch.empty((n, cout, h, w), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    lib = _lib()
    err = lib.conv3x3_launch(
        _DTYPES[x.dtype], x.data_ptr(), wk.data_ptr(),
        None if mul is None else mul.data_ptr(),
        None if add is None else add.data_ptr(), out.data_ptr(), n, h, w,
        cin, cout, int(relu), torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError('conv3x3 kernel launch failed: '
                           + lib.conv3x3_error_string(err).decode())
    launch_count += 1
    return out


class _Conv3x3(torch.autograd.Function):
    """Forward and data gradient through the kernel; the weight gradient
    through the library (the custom VJP of the JAX module)."""

    @staticmethod
    def forward(ctx, x, k):
        ctx.save_for_backward(x, k)
        return _conv(x, k, None, None, False)

    @staticmethod
    def backward(ctx, g):
        x, k = ctx.saved_tensors
        dx = dk = None
        g = g.to(x.dtype).contiguous(memory_format=torch.channels_last)
        if ctx.needs_input_grad[0]:
            kt = k.flip(0, 1).transpose(2, 3)  # rot180, Cin <-> Cout
            dx = _conv(g, kt, None, None, False)
        if ctx.needs_input_grad[1]:
            dk = torch.nn.grad.conv2d_weight(
                x, (k.shape[3], k.shape[2], 3, 3), g, padding=1)
            dk = dk.permute(2, 3, 1, 0).to(k.dtype)
        return dx, dk


def conv3x3(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """3x3 / stride-1 / SAME conv without bias. x (N, Cin, H, W) bf16 or
    f32; k (3, 3, Cin, Cout), usually float32 parameters, cast to x's
    dtype inside (as flax's nn.Conv does). Returns (N, Cout, H, W) in
    x's dtype, channels_last. Differentiable in x and k; dk comes back
    in k's dtype."""
    return _Conv3x3.apply(x, k)


def conv3x3_bn_relu(x: torch.Tensor, k: torch.Tensor, mul: torch.Tensor,
                    add: torch.Tensor, *, relu: bool = True) -> torch.Tensor:
    """Inference fusion: ``relu(conv3x3(x, k) * mul + add)`` in one pass,
    the affine and ReLU applied to the float32 accumulator before the one
    rounding. Eval only: no gradient."""
    with torch.no_grad():
        return _conv(x, k, mul, add, relu)
