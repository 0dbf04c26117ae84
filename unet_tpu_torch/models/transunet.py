"""TransUNet R50-ViT-B/16 (Chen et al., arXiv:2102.04306) as PyTorch
modules.

The published code (github.com/Beckschen/TransUNet: ``networks/
vit_seg_modeling.py``, ``vit_seg_modeling_resnet_skip.py``,
``vit_seg_configs.py::get_r50_b16_config``) with the token grid its
``train.py`` sets for R50, img/16 x img/16, so a 1x1 patch (1024 tokens
at 512^2). Width ``w`` is ``resnet_width`` (64):

  ResNetV2 root  StdConv 7x7/2 (3 -> w), GroupNorm(32), ReLU, then a 3x3
                 max pool of stride 2 without padding
  stages         ``resnet_units`` (3, 4, 9) bottlenecks to 4w, 8w, 16w
                 channels (mid w, 2w, 4w), stride 2 in the 3x3 conv of
                 the first unit of stages 2 and 3: relu(gn3(conv3(relu(
                 gn2(conv2(relu(gn1(conv1 x))))))) + residual), the first
                 unit's residual through a 1x1 StdConv (with the stride)
                 and GroupNorm(cout, cout)
  skips          [stage 2 (8w), stage 1 zero-padded at the bottom and
                 right to img/4 (4w), root (w)]
  embedding      1x1 conv 16w -> hidden, flattened to (B, N, hidden),
                 plus position embeddings, dropout
  transformer    ``num_layers`` pre-LN blocks, x + attn(LN x), then
                 x + mlp(LN x); ``num_heads`` heads of hidden / heads,
                 softmax(q k^T / sqrt(d)) v; MLP fc1, exact GELU,
                 dropout, fc2, dropout; a closing LayerNorm; LayerNorm
                 eps 1e-6
  DecoderCup     3x3 conv hidden -> 512, BatchNorm, ReLU on the token
                 grid; four blocks of a 2x align-corners upsample,
                 concat [up, skip] (the first ``n_skip`` blocks), then
                 (3x3 conv, BatchNorm, ReLU) twice, to
                 ``decoder_channels``
  head           3x3 conv with bias to the classes

StdConv2d standardises each output filter's weight at every call, (w -
mean) / sqrt(var + 1e-5) with the biased variance over (cin, kh, kw). A
1-channel input is repeated to 3 channels first. GroupNorm eps is 1e-6,
but the projection's GroupNorm keeps torch's 1e-5, as published.

The port's conventions (``models/layers.py``): float32 parameters and
BatchNorm buffers, arithmetic in the model's ``dtype`` with the weights
cast at each call, 4-D tensors in channels_last. The decoder's
conv-BatchNorm-ReLU is ``layers.Conv2d`` + ``TorchBatchNorm(relu=True)``
(the hand-written kernels on CUDA in training) and its upsampling
``upsample2x_align_corners``; attention runs ``ops.attention.attention``.
GroupNorm on a CUDA tensor runs the hand-written channels_last kernels
of ``ops.group_norm`` (training and eval), with the ReLU that follows the
root's and each bottleneck's first two GroupNorms fused into them (the
root's ``relu`` is an ``nn.Identity``); a CPU tensor keeps
``F.group_norm``. LayerNorm and the weight standardisation are ATen's.
State-dict names are the published module's, so its checkpoint loads
with a strict ``load_state_dict``.

A forward in another dtype than the parameters' casts them together
(``_CastAll``: one concatenation and one conversion) and standardises
the StdConvs' weights together by fan-in, and its backward adds the
cast parameters' gradients into one float32 buffer whose views are their
``.grad`` (``_GradBucket``): the values are those of a cast and an
accumulation a parameter, bit for bit, in a quarter fewer kernel
launches a microbatch, which the host has to issue one by one.

Dropout at ``dropout_rate`` (after the embedding, after the MLP's GELU
and after fc2) and at ``attention_dropout_rate`` (after the attention's
output projection) draws its masks from the generator
``set_dropout_generator`` gives the model, else from torch's global one;
dropout on the attention probabilities, also at
``attention_dropout_rate`` (0 as published), is the fused attention's
own.

The forward records the spans ``model.cnn`` (root, stages, embedding),
``model.transformer`` (the blocks and the closing LayerNorm) and
``model.decoder`` (DecoderCup and the head).
"""

from __future__ import annotations

import contextlib
import math
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from unet_tpu_torch.models import layers
from unet_tpu_torch.models.layers import TorchBatchNorm
from unet_tpu_torch.models.unet import _ParamCount
from unet_tpu_torch.ops.attention import attention
from unet_tpu_torch.ops.group_norm import group_norm
from unet_tpu_torch.ops.resize import upsample2x_align_corners
from unet_tpu_torch.utils.profiling import (MODEL_CNN, MODEL_DECODER,
                                            MODEL_TRANSFORMER, annotate)

# the model section's keys besides n_channels and n_classes, with the
# published values as the constructor's defaults
CONFIG_KEYS = ('img_size', 'hidden_size', 'num_layers', 'num_heads',
               'mlp_dim', 'resnet_units', 'resnet_width', 'decoder_channels',
               'n_skip', 'dropout_rate', 'attention_dropout_rate')
HEAD_CHANNELS = 512   # DecoderCup's conv_more, fixed in the published code
PATCH_STRIDE = 16     # the hybrid encoder's stride: img/16 tokens a side
_CL = torch.channels_last


def _memory_order(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` flattened in the order ``like`` lies in memory (a view where
    ``t`` lies so too)."""
    if like.dim() == 4 and not like.is_contiguous():
        return t.permute(0, 2, 3, 1).reshape(-1)
    return t.reshape(-1)


def _shaped(flat: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The inverse of ``_memory_order``: ``flat`` viewed as ``like``."""
    if like.dim() == 4 and not like.is_contiguous():
        n, c, h, w = like.shape
        return flat.view(n, h, w, c).permute(0, 3, 1, 2)
    return flat.view(like.shape)


# each tensor of a batch starts on a multiple of this many elements, so
# that every piece is as aligned as a tensor of its own for cuDNN and
# cuBLAS (an unaligned operand sends them to slow fallback kernels)
_ALIGN = 64


def _padded(n: int) -> int:
    """``n`` elements rounded up to a multiple of ``_ALIGN``."""
    return -(-n // _ALIGN) * _ALIGN


def _aligned_cat(flats: List[torch.Tensor]) -> torch.Tensor:
    """The 1-D tensors ``flats`` concatenated, each zero-padded to a
    multiple of ``_ALIGN`` elements."""
    pad = flats[0].new_zeros(_ALIGN)
    parts = []
    for f in flats:
        parts.append(f)
        if f.numel() % _ALIGN:
            parts.append(pad[:_padded(f.numel()) - f.numel()])
    return torch.cat(parts)


def _pieces(flat: torch.Tensor, tensors) -> List[torch.Tensor]:
    """The pieces of an ``_aligned_cat`` of ``tensors``' elements."""
    out, offset = [], 0
    for t in tensors:
        out.append(flat[offset:offset + t.numel()])
        offset += _padded(t.numel())
    return out


class _GradBucket:
    """One float32 buffer holding the gradients of a forward's batch-cast
    parameters, each parameter's ``.grad`` a view of it: the backward of
    the next microbatch adds to it in one kernel while every ``.grad`` is
    still its view (until the optimizer's ``zero_grad``)."""

    def __init__(self):
        self.flat: Optional[torch.Tensor] = None
        self.views: List[torch.Tensor] = []

    def __deepcopy__(self, memo):
        # a copy of the model (an EMA shadow, a replica) starts its own
        return _GradBucket()

    def accumulate(self, params, flat: torch.Tensor,
                   pieces: List[torch.Tensor]) -> None:
        """Add ``flat`` (``pieces``: its views shaped as ``params``) to the
        parameters' gradients."""
        if self.flat is not None and len(self.views) == len(params) and all(
                p.grad is v for p, v in zip(params, self.views)):
            self.flat.add_(flat)
            return
        self.flat, self.views = None, []
        if all(p.grad is None for p in params):
            self.flat, self.views = flat, pieces
            for p, v in zip(params, pieces):
                p.grad = v
            return
        for p, v in zip(params, pieces):
            if p.grad is None:
                p.grad = v.clone()
            else:
                p.grad.add_(v)


class _CastAll(torch.autograd.Function):
    """``apply(bucket, dtype, n_params, *tensors)``: the float32 tensors in
    ``dtype``, made by one concatenation and one conversion (a few
    kernels instead of one a tensor). The backward converts their
    gradients back to float32 together too; those of the first
    ``n_params`` (parameters) it adds to their ``.grad`` through
    ``bucket`` itself, as autograd's accumulation would (a kernel a
    parameter), and those of the rest it returns."""

    @staticmethod
    def forward(ctx, bucket, dtype, n_params, *tensors):
        ctx.bucket, ctx.params = bucket, tensors[:n_params]
        ctx.likes = [torch.empty_like(t, device='meta') for t in tensors]
        flat = _aligned_cat([_memory_order(t, t) for t in tensors]).to(dtype)
        return tuple(_shaped(f, t) for f, t in zip(_pieces(flat, tensors),
                                                   tensors))

    @staticmethod
    def backward(ctx, *grads):
        likes, params = ctx.likes, ctx.params
        n = len(params)
        like = next(g for g in grads if g is not None)
        flat = _aligned_cat([
            _memory_order(g, t) if g is not None
            else like.new_zeros(t.numel()) for g, t in zip(grads, likes)
        ]).float()
        pieces = [_shaped(f, t) for f, t in zip(_pieces(flat, likes), likes)]
        span = sum(_padded(t.numel()) for t in params)
        ctx.bucket.accumulate(params, flat[:span], pieces[:n])
        return (None, None, None, *([None] * n), *pieces[n:])


_local = threading.local()   # ``casts``: the running forward's casts


def _batch() -> Dict[torch.Tensor, torch.Tensor]:
    """The running forward's casts by parameter (empty outside one)."""
    return getattr(_local, 'casts', {})


def _cast(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The parameter ``p`` in ``dtype``: from the running forward's
    batch where it is there, else cast alone."""
    cast = _batch().get(p)
    return cast if cast is not None else p.to(dtype)


def _standardise(ws: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each weight of ``ws`` (conv weights of one fan-in) standardised per
    output filter, (w - mean) / sqrt(var + 1e-5) with the biased
    variance: one LayerNorm without scale over all their filters, each
    taken in the order it lies in memory (mean and variance do not
    depend on the order)."""
    rows = torch.cat([_memory_order(w, w).view(w.shape[0], -1) for w in ws])
    std = F.layer_norm(rows, rows.shape[1:], eps=1e-5)
    return [_shaped(f.reshape(-1), w)
            for f, w in zip(std.split([w.shape[0] for w in ws]), ws)]


@contextlib.contextmanager
def _batched_casts(model: nn.Module, dtype: torch.dtype):
    """Within the block, ``_cast`` of each parameter of the modules in
    ``_BATCH_CAST`` and the standardised weight of each ``StdConv2d`` are
    made together (with float32 parameters and another ``dtype``)."""
    casts: Dict[torch.Tensor, torch.Tensor] = {}
    params = [p for m in model.modules() if isinstance(m, _BATCH_CAST)
              for p in m.parameters(recurse=False)]
    if params and params[0].dtype != dtype:
        by_fan: Dict[int, List[torch.Tensor]] = {}
        for m in model.modules():
            if isinstance(m, StdConv2d):
                fan = math.prod(m.weight.shape[1:])
                by_fan.setdefault(fan, []).append(m.weight)
        convs = [w for ws in by_fan.values() for w in ws]
        std = [s for ws in by_fan.values() for s in _standardise(ws)]
        out = _CastAll.apply(model._grad_bucket, dtype, len(params),
                             *params, *std)
        casts = dict(zip(params + convs, out))
    _local.casts = casts
    try:
        yield
    finally:
        _local.casts = {}


class StdConv2d(nn.Conv2d):
    """Bias-free conv whose float32 weight is standardised per output
    filter at each call (``_standardise``), then cast to the input's
    dtype; inside a forward's batch with the other convs' of its
    fan-in."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = _batch().get(self.weight)
        if w is None:
            w = _standardise([self.weight])[0].to(x.dtype)
        return self._conv_forward(x, w, None)


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` in the input's dtype, then a ReLU if ``relu``; its
    output in channels_last. A CUDA tensor takes the hand-written kernels
    (``ops.group_norm.group_norm``, on channels_last itself), a CPU tensor
    ``F.group_norm``."""

    def __init__(self, num_groups: int, num_channels: int,
                 eps: float = 1e-5, relu: bool = False):
        super().__init__(num_groups, num_channels, eps=eps)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight = _cast(self.weight, x.dtype)
        bias = _cast(self.bias, x.dtype)
        if x.is_cuda:
            return group_norm(x, self.num_groups, weight, bias, self.eps,
                              self.relu)
        y = F.group_norm(x, self.num_groups, weight, bias, self.eps)
        y = y.contiguous(memory_format=_CL)
        return torch.relu(y) if self.relu else y


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape,
                            _cast(self.weight, x.dtype),
                            _cast(self.bias, x.dtype), self.eps)


class Linear(nn.Linear):
    """``nn.Linear`` in the input's dtype. ``xavier`` marks the published
    MLP's layers, whose init (``models.init_parameters``) draws the
    weight xavier-uniform and the bias N(0, 1e-6)."""

    def __init__(self, in_features: int, out_features: int,
                 xavier: bool = False):
        super().__init__(in_features, out_features)
        self.xavier = xavier

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, _cast(self.weight, x.dtype),
                        _cast(self.bias, x.dtype))


class Conv2d(layers.Conv2d):
    """``layers.Conv2d`` whose cast may come from the forward's batch."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else _cast(self.bias, x.dtype)
        return self._conv_forward(x, _cast(self.weight, x.dtype), bias)


class Dropout(nn.Module):
    """Inverted dropout whose mask is ``rand >= p`` (float32 uniforms of
    the input's shape) from ``generator``, or torch's global generator
    where it is None. The identity in eval mode or at p = 0."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) >= self.p
        return x * keep / (1.0 - self.p)


def set_dropout_generator(model: nn.Module,
                          generator: Optional[torch.Generator]) -> None:
    """Draw every dropout mask of ``model`` from ``generator`` (None:
    torch's global generator)."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


class PreActBottleneck(nn.Module):
    def __init__(self, cin: int, cout: int, cmid: int, stride: int = 1):
        super().__init__()
        self.gn1 = GroupNorm(32, cmid, eps=1e-6, relu=True)
        self.conv1 = StdConv2d(cin, cmid, 1, bias=False)
        self.gn2 = GroupNorm(32, cmid, eps=1e-6, relu=True)
        self.conv2 = StdConv2d(cmid, cmid, 3, stride, 1, bias=False)
        self.gn3 = GroupNorm(32, cout, eps=1e-6)
        self.conv3 = StdConv2d(cmid, cout, 1, bias=False)
        self.downsample = self.gn_proj = None
        if stride != 1 or cin != cout:
            self.downsample = StdConv2d(cin, cout, 1, stride, bias=False)
            self.gn_proj = GroupNorm(cout, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        if self.downsample is not None:
            residual = self.gn_proj(self.downsample(x))
        y = self.gn2(self.conv2(self.gn1(self.conv1(x))))
        return torch.relu(residual + self.gn3(self.conv3(y)))


def _stage(cin: int, cout: int, cmid: int, units: int,
           stride: int) -> nn.Sequential:
    blocks = [('unit1', PreActBottleneck(cin, cout, cmid, stride))]
    blocks += [(f'unit{i}', PreActBottleneck(cout, cout, cmid))
               for i in range(2, units + 1)]
    return nn.Sequential(OrderedDict(blocks))


def _pad_to(x: torch.Tensor, size: int) -> torch.Tensor:
    """Zero-pad a square map at the bottom and right to ``size``."""
    pad = size - x.shape[2]
    if pad == 0:
        return x
    if not 0 < pad < 3:
        raise ValueError(f'a {x.shape[2]}-row map cannot be padded to {size}')
    return F.pad(x, (0, pad, 0, pad)).contiguous(memory_format=_CL)


class ResNetV2(nn.Module):
    """The hybrid encoder's CNN: root, max pool, three stages; returns the
    last stage's map and the skips, deepest first."""

    def __init__(self, units: Sequence[int], width: int):
        super().__init__()
        w = width
        self.root = nn.Sequential(OrderedDict([
            ('conv', StdConv2d(3, w, 7, 2, 3, bias=False)),
            ('gn', GroupNorm(32, w, eps=1e-6, relu=True)),
            ('relu', nn.Identity())]))   # the ReLU is the norm's
        self.body = nn.Sequential(OrderedDict([
            ('block1', _stage(w, 4 * w, w, units[0], 1)),
            ('block2', _stage(4 * w, 8 * w, 2 * w, units[1], 2)),
            ('block3', _stage(8 * w, 16 * w, 4 * w, units[2], 2))]))

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        size = x.shape[2]
        x = self.root(x)
        features = [x]
        x = F.max_pool2d(x, 3, 2)
        for i, stage in enumerate(self.body):
            x = stage(x)
            if i < len(self.body) - 1:
                features.append(_pad_to(x, size // 4 // (i + 1)))
        return x, features[::-1]


class Embeddings(nn.Module):
    def __init__(self, img_size: int, hidden: int, units: Sequence[int],
                 width: int, dropout: float):
        super().__init__()
        grid = img_size // PATCH_STRIDE
        self.hybrid_model = ResNetV2(units, width)
        self.patch_embeddings = Conv2d(16 * width, hidden, 1)
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, grid * grid, hidden))
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        x, features = self.hybrid_model(x)
        x = self.patch_embeddings(x)
        # channels_last (B, C, g, g) is (B, g, g, C) in memory: the tokens
        tokens = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, x.shape[1])
        tokens = tokens + _cast(self.position_embeddings, x.dtype)
        return self.dropout(tokens), features


class Attention(nn.Module):
    def __init__(self, hidden: int, heads: int, dropout: float):
        super().__init__()
        if hidden % heads:
            raise ValueError(f'{heads} heads do not divide {hidden}')
        self.heads = heads
        self.dropout_p = float(dropout)
        self.query = Linear(hidden, hidden)
        self.key = Linear(hidden, hidden)
        self.value = Linear(hidden, hidden)
        self.out = Linear(hidden, hidden)
        self.proj_dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        # query, key and value as one product
        dt = x.dtype
        w = torch.cat([_cast(m.weight, dt) for m in (self.query, self.key,
                                                     self.value)])
        bias = torch.cat([_cast(m.bias, dt) for m in (self.query, self.key,
                                                      self.value)])
        qkv = F.linear(x, w, bias).view(b, n, 3, self.heads, c // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        ctx = attention(q, k, v, self.dropout_p if self.training else 0.0)
        ctx = ctx.transpose(1, 2).reshape(b, n, c)
        return self.proj_dropout(self.out(ctx))


class Mlp(nn.Module):
    def __init__(self, hidden: int, mlp_dim: int, dropout: float):
        super().__init__()
        self.fc1 = Linear(hidden, mlp_dim, xavier=True)
        self.fc2 = Linear(mlp_dim, hidden, xavier=True)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.dropout(F.gelu(self.fc1(x)))
        return self.dropout(self.fc2(x))


class Block(nn.Module):
    def __init__(self, hidden: int, heads: int, mlp_dim: int,
                 dropout: float, attention_dropout: float):
        super().__init__()
        self.attention_norm = LayerNorm(hidden, eps=1e-6)
        self.ffn_norm = LayerNorm(hidden, eps=1e-6)
        self.ffn = Mlp(hidden, mlp_dim, dropout)
        self.attn = Attention(hidden, heads, attention_dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.attention_norm(x))
        return x + self.ffn(self.ffn_norm(x))


class Encoder(nn.Module):
    def __init__(self, layers: int, *block_args):
        super().__init__()
        self.layer = nn.ModuleList(Block(*block_args) for _ in range(layers))
        self.encoder_norm = LayerNorm(block_args[0], eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.layer:
            x = block(x)
        return self.encoder_norm(x)


class Transformer(nn.Module):
    """The published container of the embedding and the encoder (for
    the state dict's names); ``TransUNet.forward`` runs its parts."""

    def __init__(self, embeddings: Embeddings, encoder: Encoder):
        super().__init__()
        self.embeddings = embeddings
        self.encoder = encoder


def _conv_bn_relu(cin: int, cout: int) -> nn.Sequential:
    """The published Conv2dReLU: 3x3 conv without bias, BatchNorm, ReLU
    (inside the BatchNorm; the Identity keeps index 2)."""
    return nn.Sequential(Conv2d(cin, cout, 3, padding=1, bias=False),
                         TorchBatchNorm(cout, relu=True), nn.Identity())


class DecoderBlock(nn.Module):
    def __init__(self, cin: int, cout: int, skip: int):
        super().__init__()
        self.conv1 = _conv_bn_relu(cin + skip, cout)
        self.conv2 = _conv_bn_relu(cout, cout)

    def forward(self, x: torch.Tensor,
                skip: Optional[torch.Tensor]) -> torch.Tensor:
        x = upsample2x_align_corners(x)
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        return self.conv2(self.conv1(x))


class DecoderCup(nn.Module):
    def __init__(self, hidden: int, channels: Sequence[int],
                 skips: Sequence[int]):
        super().__init__()
        self.n_skip = sum(s > 0 for s in skips)
        self.conv_more = _conv_bn_relu(hidden, HEAD_CHANNELS)
        ins = [HEAD_CHANNELS] + list(channels[:-1])
        self.blocks = nn.ModuleList(DecoderBlock(i, o, s) for i, o, s in
                                    zip(ins, channels, skips))

    def forward(self, tokens: torch.Tensor,
                features: List[torch.Tensor]) -> torch.Tensor:
        b, n, c = tokens.shape
        g = math.isqrt(n)
        # (B, g, g, C) tokens as a channels_last (B, C, g, g) view
        x = self.conv_more(tokens.view(b, g, g, c).permute(0, 3, 1, 2))
        for i, block in enumerate(self.blocks):
            x = block(x, features[i] if i < self.n_skip else None)
        return x


class TransUNet(_ParamCount, nn.Module):
    """TransUNet R50-ViT-B/16 at ``img_size``^2 (a multiple of 16); the
    defaults are the published configuration. Input (N, n_channels, H,
    W) with n_channels 1 (repeated to 3) or 3; output float32 logits
    (N, n_classes, H, W)."""

    def __init__(self, n_channels: int = 1, n_classes: int = 2,
                 img_size: int = 512, hidden_size: int = 768,
                 num_layers: int = 12, num_heads: int = 12,
                 mlp_dim: int = 3072,
                 resnet_units: Sequence[int] = (3, 4, 9),
                 resnet_width: int = 64,
                 decoder_channels: Sequence[int] = (256, 128, 64, 16),
                 n_skip: int = 3, dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if img_size % PATCH_STRIDE:
            raise ValueError(f'TransUNet needs an image side divisible by '
                             f'{PATCH_STRIDE}, got {img_size}')
        if n_channels not in (1, 3):
            raise ValueError(f'TransUNet takes 1 or 3 input channels, got '
                             f'{n_channels}')
        if len(decoder_channels) != 4 or not 0 <= n_skip <= 3:
            raise ValueError('TransUNet has four decoder blocks and at most '
                             'three skips')
        self.n_channels, self.n_classes = n_channels, n_classes
        self.img_size, self.dtype = img_size, dtype
        w = resnet_width
        skips = [s if i < n_skip else 0
                 for i, s in enumerate((8 * w, 4 * w, w, 0))]
        self.transformer = Transformer(
            Embeddings(img_size, hidden_size, resnet_units, w, dropout_rate),
            Encoder(num_layers, hidden_size, num_heads, mlp_dim,
                    dropout_rate, attention_dropout_rate))
        self.decoder = DecoderCup(hidden_size, decoder_channels, skips)
        self.segmentation_head = nn.Sequential(
            Conv2d(decoder_channels[-1], n_classes, 3, padding=1),
            nn.Identity())
        self._grad_bucket = _GradBucket()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if x.shape[1] == 1:
            x = x.expand(-1, 3, -1, -1)
        x = x.contiguous(memory_format=_CL)
        dev = x.device
        with _batched_casts(self, self.dtype):
            with annotate(MODEL_CNN, dev):
                tokens, features = self.transformer.embeddings(x)
            with annotate(MODEL_TRANSFORMER, dev):
                tokens = self.transformer.encoder(tokens)
            with annotate(MODEL_DECODER, dev):
                y = self.segmentation_head(self.decoder(tokens, features))
        return y.float()


# the modules whose own parameters a forward casts in one batch: all but
# the standardised convs (standardised in float32 first) and BatchNorm
# (whose float32 parameters the kernels take as they are)
_BATCH_CAST = (GroupNorm, LayerNorm, Linear, Conv2d, Embeddings)
