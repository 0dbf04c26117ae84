"""Train-mode BatchNorm (+ReLU): CUDA kernel wrapper and plain version.

Replaces no TPU kernel: the JAX package writes BatchNorm as plain jnp and
XLA fuses it. ``batch_norm_train`` is ``TorchBatchNorm``'s training mode
(torch semantics: biased batch variance ``E[x^2] - mean^2`` clamped at
0 for the normalisation, the unbiased one into ``running_var``, momentum
0.1, ``num_batches_tracked += 1``), optionally with the ReLU after it,
as one ``torch.autograd.Function`` of two passes each way:

  forward   sums of x and x^2 per channel -> mean, rstd, running stats;
            y = relu?((x - mean) * weight * rstd + bias)
  backward  S1 = sum dy', S2 = sum dy' * xhat per channel (dy' is dy
            where the ReLU passed, xhat = (x - mean) * rstd);
            dx = weight * rstd * (dy' - S1 / n - xhat * S2 / n),
            dweight = S2, dbias = S1

Inside a process group of several ranks the per-channel sums are summed
over the ranks between the passes (``[sum x, sum x^2, n]`` before the
statistics are formed, ``[S1, S2]`` before dx), so the statistics are the
global batch's and dx is the gradient through them; dweight and dbias
stay this rank's, as autograd gives them.

``batch_norm_train`` takes CUDA tensors: it runs the hand-written kernels
(``KernelPasses``, ``unet_tpu_torch/csrc/batch_norm.cu``: bf16 or float32,
channels_last, arithmetic in float32, rounded once to the input's type) or
raises. ``PlainPasses`` are the same two passes in plain PyTorch, in
float32 (float64 for float64 inputs), for ``BatchNormTrain.apply``: the
tests hold them against autograd through the eager ``TorchBatchNorm``
(which CPU tensors take) and the kernels against them.
"""

from __future__ import annotations

import ctypes
import torch

from unet_tpu_torch.core.distributed import all_reduce_sum_, is_distributed
from unet_tpu_torch.ops import _build

# Kernel launches of one call, forward and backward (inside a process
# group the forward's finalize runs apart, after the all-reduce: one more).
LAUNCHES_PER_CALL = 6

_CL = torch.channels_last
_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
# bn_max_row_blocks: a statistics pass writes at most that many x 2 x C
# partial sums
KERNELS = _build.Kernels('batch_norm', 'bn_error_string', {
    'bn_max_row_blocks': ([], 0),
    'bn_forward_stats': ([_P, _I, _LL, _I, _P, _P, _I, _F, _F, _F]
                         + [_P] * 5, 2),
    'bn_forward_finalize': ([_P, _I, _F, _F, _F] + [_P] * 5, 1),
    'bn_forward_apply': ([_P, _I, _LL, _I, _P, _P, _P, _I, _P, _P], 1),
    'bn_backward_sums': ([_P, _P, _I, _LL, _I, _P, _P, _P, _I, _P, _P, _P],
                         2),
    'bn_backward_input': ([_P, _P, _I, _LL, _I, _P, _P, _P, _I, _P, _P,
                           _P], 1)})


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


class PlainPasses:
    """The two passes in plain PyTorch, step for step as the kernels;
    ``sc`` is ``[mean (C) | rstd (C) | n]``."""

    @staticmethod
    def stats(x):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        return torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)),
                          xf.new_full((1,), x.numel() // x.shape[1])])

    @staticmethod
    def finalize(stats, fin):
        running_mean, running_var, tracked, eps, keep = fin
        c = (stats.numel() - 1) // 2
        n = stats[2 * c]
        mean = stats[:c] / n
        var = torch.clamp(stats[c:2 * c] / n - mean * mean, min=0.0)
        with torch.no_grad():
            running_mean.copy_(keep * running_mean + (1.0 - keep) * mean)
            running_var.copy_(keep * running_var + (1.0 - keep) * var
                              * (n / torch.clamp(n - 1, min=1)))
            tracked += 1
        return torch.cat([mean, torch.rsqrt(var + eps), n[None]])

    @classmethod
    def stats_finalize(cls, x, fin):
        return cls.finalize(cls.stats(x), fin)

    @staticmethod
    def _parts(x, sc, weight, bias):
        c = x.shape[1]
        mean, rstd = _per_channel(sc[:c]), _per_channel(sc[c:2 * c])
        mul = _per_channel(weight.to(sc.dtype)) * rstd
        return x.to(sc.dtype) - mean, rstd, mul, _per_channel(
            bias.to(sc.dtype))

    @classmethod
    def apply(cls, x, sc, weight, bias, relu):
        centred, _, mul, b = cls._parts(x, sc, weight, bias)
        y = centred * mul + b
        return (torch.relu(y) if relu else y).to(x.dtype)

    @classmethod
    def _grad(cls, dy, x, sc, weight, bias, relu):
        centred, rstd, mul, b = cls._parts(x, sc, weight, bias)
        g = dy.to(sc.dtype)
        if relu:
            g = torch.where(centred * mul + b > 0, g, torch.zeros_like(g))
        return g, centred * rstd, mul

    @classmethod
    def grad_sums(cls, dy, x, sc, weight, bias, relu):
        g, xhat, _ = cls._grad(dy, x, sc, weight, bias, relu)
        return torch.cat([g.sum((0, 2, 3)), (g * xhat).sum((0, 2, 3))])

    @classmethod
    def grad_input(cls, dy, x, sc, weight, bias, relu, sums):
        c = x.shape[1]
        g, xhat, mul = cls._grad(dy, x, sc, weight, bias, relu)
        n = sc[2 * c]
        dx = mul * (g - _per_channel(sums[:c] / n)
                    - xhat * _per_channel(sums[c:] / n))
        return dx.to(x.dtype)


class KernelPasses:
    """The two passes as kernel launches on ``stream`` (a cudaStream_t as
    an int: the forward's, on which autograd also runs the backward);
    the same interface as ``PlainPasses``."""

    def __init__(self, stream: int):
        self.stream = stream

    @staticmethod
    def _scratch(x, extra):
        """One float32 buffer: a pass's per-block partial sums, then
        ``extra`` floats; returns it and the partials' length."""
        n = KERNELS.bn_max_row_blocks * 2 * x.shape[1]
        return torch.empty(n + extra, dtype=torch.float32,
                           device=x.device), n

    @staticmethod
    def _fin_args(fin):
        running_mean, running_var, tracked, eps, keep = fin
        return (eps, keep, 1.0 - keep, running_mean.data_ptr(),
                running_var.data_ptr(), tracked.data_ptr())

    @staticmethod
    def _rows(x):
        return x.dtype == torch.bfloat16, x.numel() // x.shape[1], x.shape[1]

    def stats(self, x):
        """[sum x | sum x^2 | n] (a view of the pass's scratch)."""
        k = 2 * x.shape[1] + 1
        buf, n = self._scratch(x, k)
        stats = buf[n:]
        KERNELS.bn_forward_stats(
            x.data_ptr(), *self._rows(x), buf.data_ptr(), stats.data_ptr(),
            False, 0.0, 0.0, 0.0, None, None, None, None, self.stream)
        return stats

    def stats_finalize(self, x, fin):
        """The finalized sc (its own buffer: it is saved for backward)."""
        k = 2 * x.shape[1] + 1
        buf, n = self._scratch(x, k)
        sc = torch.empty(k, dtype=torch.float32, device=x.device)
        ptr = buf.data_ptr()
        KERNELS.bn_forward_stats(
            x.data_ptr(), *self._rows(x), ptr, ptr + 4 * n, True,
            *self._fin_args(fin), sc.data_ptr(), self.stream)
        return sc

    def finalize(self, stats, fin):
        sc = torch.empty_like(stats)
        KERNELS.bn_forward_finalize(
            stats.data_ptr(), (stats.numel() - 1) // 2, *self._fin_args(fin),
            sc.data_ptr(), self.stream)
        return sc

    def apply(self, x, sc, weight, bias, relu):
        y = torch.empty_like(x, memory_format=_CL)
        KERNELS.bn_forward_apply(
            x.data_ptr(), *self._rows(x), sc.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), relu, y.data_ptr(), self.stream)
        return y

    def grad_sums(self, dy, x, sc, weight, bias, relu):
        # the sums in their own buffer: dweight and dbias are views of it
        buf, _ = self._scratch(x, 0)
        sums = torch.empty(2 * x.shape[1], dtype=torch.float32,
                           device=x.device)
        KERNELS.bn_backward_sums(
            dy.data_ptr(), x.data_ptr(), *self._rows(x), sc.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), relu, buf.data_ptr(),
            sums.data_ptr(), self.stream)
        return sums

    def grad_input(self, dy, x, sc, weight, bias, relu, sums):
        dx = torch.empty_like(x, memory_format=_CL)
        KERNELS.bn_backward_input(
            dy.data_ptr(), x.data_ptr(), *self._rows(x), sc.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), relu, sums.data_ptr(),
            dx.data_ptr(), self.stream)
        return dx


def check_map(op: str, x: torch.Tensor) -> None:
    """Raise unless the norm kernels (this module's and ``group_norm``'s)
    take the map x: bf16 or float32, 4-D, contiguous in channels_last, not
    empty, on the current CUDA device."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f'{op}: x is {x.dtype}; the kernels take '
                        'bfloat16 or float32')
    if x.dim() != 4 or not x.is_contiguous(memory_format=_CL):
        raise ValueError(f'{op}: x {tuple(x.shape)} must be 4-D and '
                         'contiguous in torch.channels_last')
    if x.numel() == 0:
        raise ValueError(f'{op}: x is empty')
    _build.check_device(op, x)


def check_kernel_args(x, weight, bias, running_mean, running_var,
                      tracked) -> None:
    """Raise unless the kernels take these tensors: x as ``check_map``
    says; the parameters and running statistics float32 vectors of C, the
    count an int64 scalar, all on x's device."""
    check_map('batch_norm', x)
    c = x.shape[1]
    for name, t in (('weight', weight), ('bias', bias),
                    ('running_mean', running_mean),
                    ('running_var', running_var)):
        if (t.dtype != torch.float32 or t.shape != (c,)
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f'batch_norm: {name} must be a contiguous '
                             f'float32 vector of {c} on {x.device}')
    if tracked.dtype != torch.int64 or tracked.device != x.device:
        raise ValueError('batch_norm: num_batches_tracked must be an int64 '
                         f'scalar on {x.device}')


class BatchNormTrain(torch.autograd.Function):
    """``apply(x, weight, bias, (running_mean, running_var, tracked, eps,
    keep), relu, ops)``: the two passes each way through ``ops`` (a
    ``KernelPasses`` or ``PlainPasses``), with the all-reduces between
    them inside a process group."""

    @staticmethod
    def forward(ctx, x, weight, bias, fin, relu, ops):
        if is_distributed():
            sc = ops.finalize(all_reduce_sum_(ops.stats(x)), fin)
        else:
            sc = ops.stats_finalize(x, fin)
        ctx.save_for_backward(x, weight, bias, sc)
        ctx.relu, ctx.ops = relu, ops
        return ops.apply(x, sc, weight, bias, relu)

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, sc = ctx.saved_tensors
        ops, relu = ctx.ops, ctx.relu
        dy = dy.to(x.dtype).contiguous(memory_format=_CL)
        sums = ops.grad_sums(dy, x, sc, weight, bias, relu)
        total = all_reduce_sum_(sums.clone()) if is_distributed() else sums
        dx = ops.grad_input(dy, x, sc, weight, bias, relu, total)
        c = x.shape[1]
        return dx, sums[c:], sums[:c], None, None, None


def batch_norm_train(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, running_mean: torch.Tensor,
                     running_var: torch.Tensor, tracked: torch.Tensor,
                     eps: float, keep: float, relu: bool) -> torch.Tensor:
    """Train-mode BatchNorm of x (N, C, H, W), then ReLU if ``relu``;
    updates ``running_mean`` and ``running_var`` (``keep`` of the old
    value, e.g. 0.9 for torch's momentum 0.1) and ``tracked`` in place.
    Differentiable in x, weight and bias. Launches the kernels on the
    current stream, or raises unless ``check_kernel_args`` passes."""
    check_kernel_args(x, weight, bias, running_mean, running_var, tracked)
    return BatchNormTrain.apply(
        x, weight, bias, (running_mean, running_var, tracked, eps, keep),
        bool(relu), KernelPasses(torch.cuda.current_stream().cuda_stream))


