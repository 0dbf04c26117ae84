"""GroupNorm (+ReLU) on channels_last maps: CUDA kernel wrapper and plain
version.

Replaces no TPU kernel: the JAX package has no GroupNorm. ``group_norm``
is TransUNet's GroupNorm (``models/transunet.py``; torch semantics:
statistics per (sample, group) over H x W x (C / G), the biased variance,
the module's eps), optionally with the ReLU after it, as one
``torch.autograd.Function`` of two passes each way:

  forward   per (sample, channel) sums of d = x - k and d^2, k the
            channel's value at the map's first pixel; per (sample, group)
            mean and rstd from them (the channels' centred sums merged);
            per (sample, channel) a = rstd * w, b = bias - mean * a;
            y = relu?(a * x + b)
  backward  per (sample, channel) S1 = sum dy', S2 = sum dy' * xhat
            (dy' is dy where the forward's output was positive, xhat =
            (x - mean) * rstd); per (sample, group) A = sum w S1 / M,
            B = sum w S2 / M (M = H W C / G), c1 = -rstd^2 B,
            c2 = rstd (rstd B mean - A); dx = a * dy' + c1 * x + c2;
            dbias = sum S1, dweight = sum S2 over the samples

GroupNorm keeps no running statistics, so training and eval run the same
forward, and a process group needs no all-reduce.

``group_norm`` takes CUDA tensors: it runs the hand-written kernels
(``KernelPasses``, ``unet_tpu_torch/csrc/group_norm.cu``: x bf16 or
float32, channels_last, weight and bias in x's dtype, arithmetic in
float32, rounded once to x's type) or raises. ``PlainPasses`` are the same
two passes in plain PyTorch, in float32 (float64 for float64 inputs), for
``GroupNormFn.apply``: the tests hold them against autograd through
``F.group_norm`` (which CPU tensors keep) and the kernels against them.
"""

from __future__ import annotations

import ctypes

import torch

from unet_tpu_torch.ops import _build
from unet_tpu_torch.ops.batch_norm import check_map

# Kernel launches of one call, forward and backward.
LAUNCHES_PER_CALL = 6

_CL = torch.channels_last
_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
# The library's limits, read once: its block cap (a statistics pass
# writes at most (gn_max_blocks + N) * 2 * C partial sums), the channels
# a group may hold at most, and the bytes of a load along C (C a multiple
# of its values, every map aligned to it).
KERNELS = _build.Kernels('group_norm', 'gn_error_string', {
    'gn_max_blocks': ([], 0), 'gn_max_group_channels': ([], 0),
    'gn_vector_bytes': ([], 0),
    'gn_forward_stats': ([_P, _I, _I, _LL, _I, _I, _F, _P, _P, _P, _P, _P],
                         2),
    'gn_forward_apply': ([_P, _I, _I, _LL, _I, _I, _P, _I, _P, _P], 1),
    'gn_backward_sums': ([_P, _P, _I, _I, _LL, _I, _I, _P, _P, _I, _P, _P,
                          _P, _P], 2),
    'gn_backward_input': ([_P, _P, _I, _I, _LL, _I, _I, _P, _P, _P, _I, _P,
                           _P, _P, _P], 1)})


def _unpack(sc, x, groups):
    """a, b (N, C, 1, 1) and mean, rstd (N, G) of ``sc = [a | b | mean |
    rstd]``."""
    n, c = x.shape[:2]
    a, b, mean, rstd = sc.split([n * c, n * c, n * groups, n * groups])
    return (a.view(n, c, 1, 1), b.view(n, c, 1, 1), mean.view(n, groups),
            rstd.view(n, groups))


def _per_channel(v: torch.Tensor, c: int) -> torch.Tensor:
    """A per-(sample, group) value (N, G) for every channel, (N, C, 1, 1)."""
    return v.repeat_interleave(c // v.shape[1], 1)[:, :, None, None]


class PlainPasses:
    """The two passes in plain PyTorch, step for step as the kernels; ``sc``
    is ``[a (N, C) | b (N, C) | mean (N, G) | rstd (N, G)]``, ``sums``
    ``[S1 (N, C) | S2 (N, C)]``, ``coef`` ``[c1 (N, G) | c2 (N, G)]``."""

    @staticmethod
    def incoming(dy, x):
        """The backward's dy in x's dtype and layout."""
        return dy.to(x.dtype).contiguous(memory_format=_CL)

    @staticmethod
    def stats_finalize(x, weight, bias, groups, eps):
        n, c, h, w = x.shape
        hw, cpg = h * w, c // groups
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        shift = xf[:, :, :1, :1]
        d = xf - shift
        s1, s2 = d.sum((2, 3)), (d * d).sum((2, 3))
        dm = s1 / hw
        mean_c = (shift[:, :, 0, 0] + dm).view(n, groups, cpg)
        m2_c = torch.clamp(s2 - s1 * dm, min=0.0).view(n, groups, cpg)
        mean = mean_c.sum(2) / cpg
        m2 = (m2_c + hw * (mean_c - mean[:, :, None]) ** 2).sum(2)
        rstd = torch.rsqrt(m2 / (hw * cpg) + eps)
        a = _per_channel(rstd, c)[:, :, 0, 0] * weight.to(xf.dtype)
        b = bias.to(xf.dtype) - _per_channel(mean, c)[:, :, 0, 0] * a
        return torch.cat([a.reshape(-1), b.reshape(-1), mean.reshape(-1),
                          rstd.reshape(-1)])

    @staticmethod
    def apply(x, sc, groups, relu):
        a, b, _, _ = _unpack(sc, x, groups)
        y = x.to(sc.dtype) * a + b
        return (torch.relu(y) if relu else y).to(x.dtype)

    @staticmethod
    def _masked(dy, x, sc, groups, relu):
        a, b, _, _ = _unpack(sc, x, groups)
        xf, g = x.to(sc.dtype), dy.to(sc.dtype)
        if relu:
            g = torch.where(xf * a + b > 0, g, torch.zeros_like(g))
        return xf, g

    @classmethod
    def grad_sums(cls, dy, x, sc, weight, groups, relu):
        """(sums, coef)."""
        n, c, h, w = x.shape
        _, _, mean, rstd = _unpack(sc, x, groups)
        xf, g = cls._masked(dy, x, sc, groups, relu)
        s1 = g.sum((2, 3))
        sx = (g * (xf - _per_channel(mean, c))).sum((2, 3)) \
            * _per_channel(rstd, c)[:, :, 0, 0]
        wf, m = weight.to(sc.dtype), h * w * (c // groups)
        a = (wf * s1).view(n, groups, -1).sum(2) / m
        b = (wf * sx).view(n, groups, -1).sum(2) / m
        c1 = -(rstd * rstd) * b
        c2 = rstd * (rstd * b * mean - a)
        return (torch.cat([s1.reshape(-1), sx.reshape(-1)]),
                torch.cat([c1.reshape(-1), c2.reshape(-1)]))

    @classmethod
    def grad_input(cls, dy, x, sc, sums, coef, groups, relu):
        """(dx, dweight, dbias), all in x's dtype."""
        n, c = x.shape[:2]
        a, _, _, _ = _unpack(sc, x, groups)
        c1, c2 = (_per_channel(v.view(n, groups), c) for v in coef.chunk(2))
        xf, g = cls._masked(dy, x, sc, groups, relu)
        s1, sx = sums.view(2, n, c)
        return ((a * g + c1 * xf + c2).to(x.dtype), sx.sum(0).to(x.dtype),
                s1.sum(0).to(x.dtype))


class KernelPasses:
    """The two passes as kernel launches on ``stream`` (a cudaStream_t as
    an int: the forward's, on which autograd also runs the backward);
    the same interface as ``PlainPasses``."""

    def __init__(self, stream: int):
        self.stream = stream

    @staticmethod
    def _partial(x):
        n, c = x.shape[:2]
        return torch.empty((KERNELS.gn_max_blocks + n) * 2 * c,
                           dtype=torch.float32, device=x.device)

    @staticmethod
    def _dims(x, groups):
        n, c, h, w = x.shape
        return x.dtype == torch.bfloat16, n, h * w, c, c // groups

    def incoming(self, dy, x):
        """The backward's dy in x's dtype and layout, copied where autograd
        hands on a view that starts off a load's boundary."""
        dy = PlainPasses.incoming(dy, x)
        if dy.data_ptr() % KERNELS.gn_vector_bytes:
            dy = dy.clone(memory_format=_CL)
        return dy

    def stats_finalize(self, x, weight, bias, groups, eps):
        n, c = x.shape[:2]
        sc = torch.empty(2 * n * (c + groups), dtype=torch.float32,
                         device=x.device)
        KERNELS.gn_forward_stats(
            x.data_ptr(), *self._dims(x, groups), eps, weight.data_ptr(),
            bias.data_ptr(), self._partial(x).data_ptr(), sc.data_ptr(),
            self.stream)
        return sc

    def apply(self, x, sc, groups, relu):
        y = torch.empty_like(x, memory_format=_CL)
        KERNELS.gn_forward_apply(
            x.data_ptr(), *self._dims(x, groups), sc.data_ptr(), relu,
            y.data_ptr(), self.stream)
        return y

    def grad_sums(self, dy, x, sc, weight, groups, relu):
        n, c = x.shape[:2]
        buf = torch.empty(2 * n * (c + groups), dtype=torch.float32,
                          device=x.device)
        sums, coef = buf.split([2 * n * c, 2 * n * groups])
        KERNELS.gn_backward_sums(
            dy.data_ptr(), x.data_ptr(), *self._dims(x, groups),
            sc.data_ptr(), weight.data_ptr(), relu,
            self._partial(x).data_ptr(), sums.data_ptr(), coef.data_ptr(),
            self.stream)
        return sums, coef

    def grad_input(self, dy, x, sc, sums, coef, groups, relu):
        dx = torch.empty_like(x, memory_format=_CL)
        dweight = torch.empty(x.shape[1], dtype=x.dtype, device=x.device)
        dbias = torch.empty_like(dweight)
        KERNELS.gn_backward_input(
            dy.data_ptr(), x.data_ptr(), *self._dims(x, groups),
            sc.data_ptr(), coef.data_ptr(), sums.data_ptr(), relu,
            dx.data_ptr(), dweight.data_ptr(), dbias.data_ptr(), self.stream)
        return dx, dweight, dbias


def check_kernel_args(x, groups, weight, bias) -> None:
    """Raise unless the kernels take these tensors: x as
    ``batch_norm.check_map`` says, its channels a multiple of a load's
    values and its data aligned to a load (``gn_vector_bytes``); groups
    dividing C into at most ``gn_max_group_channels`` channels each;
    weight and bias contiguous vectors of C in x's dtype on x's device."""
    check_map('group_norm', x)
    c, load = x.shape[1], KERNELS.gn_vector_bytes
    if c % (load // x.element_size()) or x.data_ptr() % load:
        raise ValueError(f'group_norm: the kernels load {load} B along C: '
                         f'{c} channels of {x.dtype} must fill whole loads '
                         'and x must start on a load\'s boundary')
    most = KERNELS.gn_max_group_channels
    if groups < 1 or c % groups or c // groups > most:
        raise ValueError(f'group_norm: {groups} groups of {c} channels; '
                         f'the kernels take groups of at most {most} '
                         'channels')
    for name, t in (('weight', weight), ('bias', bias)):
        if (t.dtype != x.dtype or t.shape != (c,) or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f'group_norm: {name} must be a contiguous '
                             f'{x.dtype} vector of {c} on {x.device}')


class GroupNormFn(torch.autograd.Function):
    """``apply(x, weight, bias, groups, eps, relu, ops)``: the two passes
    each way through ``ops`` (a ``KernelPasses`` or ``PlainPasses``)."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps, relu, ops):
        sc = ops.stats_finalize(x, weight, bias, groups, eps)
        ctx.save_for_backward(x, weight, sc)
        ctx.groups, ctx.relu, ctx.ops = groups, relu, ops
        return ops.apply(x, sc, groups, relu)

    @staticmethod
    def backward(ctx, dy):
        x, weight, sc = ctx.saved_tensors
        ops, groups, relu = ctx.ops, ctx.groups, ctx.relu
        dy = ops.incoming(dy, x)
        sums, coef = ops.grad_sums(dy, x, sc, weight, groups, relu)
        dx, dweight, dbias = ops.grad_input(dy, x, sc, sums, coef, groups,
                                            relu)
        return dx, dweight, dbias, None, None, None, None


def group_norm(x: torch.Tensor, groups: int, weight: torch.Tensor,
               bias: torch.Tensor, eps: float, relu: bool) -> torch.Tensor:
    """GroupNorm of x (N, C, H, W) in ``groups`` groups, then ReLU if
    ``relu``; differentiable in x, weight and bias. Launches the kernels
    on the current stream, or raises unless ``check_kernel_args``
    passes."""
    check_kernel_args(x, groups, weight, bias)
    return GroupNormFn.apply(
        x, weight, bias, int(groups), float(eps), bool(relu),
        KernelPasses(torch.cuda.current_stream().cuda_stream))
