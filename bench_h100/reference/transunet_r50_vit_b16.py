"""TransUNet R50-ViT-B/16 (Chen et al., arXiv:2102.04306) in plain PyTorch,
float32: the plain reference of the port's ``transunet_r50_vit_b16``.

It follows the published code, github.com/Beckschen/TransUNet:
``networks/vit_seg_modeling.py`` (Embeddings, Attention, Mlp, Block,
Encoder, DecoderCup, SegmentationHead, VisionTransformer),
``networks/vit_seg_modeling_resnet_skip.py`` (StdConv2d,
PreActBottleneck, ResNetV2) and ``networks/vit_seg_configs.py::
get_r50_b16_config``, with the token grid its ``train.py`` sets for R50
(img/16 a side, so a 1x1 patch and 1024 tokens at 512^2). Attention is
written out: softmax(q k^T / sqrt(d)) v, the scores and probabilities
in memory. The forward departs from the published code nowhere; the
stage-1 skip's zero padding at the bottom and right is ``F.pad``, where
the published code copies the map into a zero tensor. The model
section's keys (``PUBLISHED`` gives each one's published value, the
default) are the port's; ``img_size`` sets the grid. Its state dict's
names are the published module's, which are the port's.

One file, byte for byte, serves the port's CPU tests
(``tests/plain_transunet.py``) and the benchmark
(``bench_h100/reference/transunet_r50_vit_b16.py``), so it imports
``torch`` and the standard library alone. It has the hooks
``bench_h100/reference/__init__.py`` lists:

* ``Net(model_cfg)``: the network; building it turns TF32 off for
  matrix products and convolutions, so float32 is float32 on the card;
* ``set_fp8(net, on)``: the control, which rounds the inputs and weights
  of every convolution (the standardised weights of the StdConvs) and
  Linear layer, and both operands of attention's two products, to
  float8 e4m3 (one scale per tensor; gradients pass straight through);
* ``flops_per_slice(model_cfg, img)``: every convolution's, Linear
  layer's and attention product's operations, the head's included;
  ``attention_flops_per_slice(img, hidden, layers)`` is the attention
  products' share of it;
* ``init_plan(shapes)``: the published init, torch's default
  U(+-1/sqrt(fan_in)) for convolutions and the attention's Linear
  layers, xavier-uniform weights and N(0, 1e-6) biases for the MLP's,
  ones and zeros for every norm, zeros for the position embeddings.

Dropout (``dropout_rate``, ``attention_dropout_rate``) draws its masks,
``rand >= p`` of the tensor's shape in float32, from the generator
``set_dropout_generator`` gives, as the port's does, so that a test can
hand both the same masks.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

PUBLISHED = {'n_channels': 1, 'n_classes': 2, 'img_size': 512,
             'hidden_size': 768, 'num_layers': 12, 'num_heads': 12,
             'mlp_dim': 3072, 'resnet_units': (3, 4, 9), 'resnet_width': 64,
             'decoder_channels': (256, 128, 64, 16), 'n_skip': 3,
             'dropout_rate': 0.1, 'attention_dropout_rate': 0.0}
HEAD_CHANNELS = 512
FP8_MAX = 448.0  # largest finite float8 e4m3fn


def _cfg(model_cfg: Dict) -> Dict:
    return {k: model_cfg.get(k, v) for k, v in PUBLISHED.items()}


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, as float32;
    the gradient passes straight through."""
    amax = x.detach().abs().amax().clamp(min=1e-12)
    s = FP8_MAX / amax
    q = (x.detach() * s).to(torch.float8_e4m3fn).to(x.dtype) / s
    return x + (q - x.detach())


def _fp8(x: torch.Tensor, on: bool) -> torch.Tensor:
    return fp8_round(x) if on else x


class Conv(nn.Conv2d):
    fp8 = False

    def forward(self, x):
        return self._conv_forward(_fp8(x, self.fp8),
                                  _fp8(self.weight, self.fp8), self.bias)


class StdConv2d(nn.Conv2d):
    fp8 = False

    def forward(self, x):
        w = self.weight
        v, m = torch.var_mean(w, dim=[1, 2, 3], keepdim=True, unbiased=False)
        w = (w - m) / torch.sqrt(v + 1e-5)
        return F.conv2d(_fp8(x, self.fp8), _fp8(w, self.fp8), self.bias,
                        self.stride, self.padding, self.dilation,
                        self.groups)


class Linear(nn.Linear):
    fp8 = False

    def forward(self, x):
        return F.linear(_fp8(x, self.fp8), _fp8(self.weight, self.fp8),
                        self.bias)


class Dropout(nn.Module):
    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) >= self.p
        return x * keep / (1.0 - self.p)


def set_dropout_generator(net: nn.Module,
                          generator: Optional[torch.Generator]) -> None:
    for m in net.modules():
        if isinstance(m, Dropout):
            m.generator = generator


class PreActBottleneck(nn.Module):
    def __init__(self, cin: int, cout: int, cmid: int, stride: int = 1):
        super().__init__()
        self.gn1 = nn.GroupNorm(32, cmid, eps=1e-6)
        self.conv1 = StdConv2d(cin, cmid, 1, bias=False)
        self.gn2 = nn.GroupNorm(32, cmid, eps=1e-6)
        self.conv2 = StdConv2d(cmid, cmid, 3, stride, 1, bias=False)
        self.gn3 = nn.GroupNorm(32, cout, eps=1e-6)
        self.conv3 = StdConv2d(cmid, cout, 1, bias=False)
        self.relu = nn.ReLU()
        if stride != 1 or cin != cout:
            self.downsample = StdConv2d(cin, cout, 1, stride, bias=False)
            self.gn_proj = nn.GroupNorm(cout, cout)

    def forward(self, x):
        residual = x
        if hasattr(self, 'downsample'):
            residual = self.gn_proj(self.downsample(x))
        y = self.relu(self.gn1(self.conv1(x)))
        y = self.relu(self.gn2(self.conv2(y)))
        y = self.gn3(self.conv3(y))
        return self.relu(residual + y)


def _stage(cin, cout, cmid, units, stride):
    return nn.Sequential(OrderedDict(
        [('unit1', PreActBottleneck(cin, cout, cmid, stride))]
        + [(f'unit{i}', PreActBottleneck(cout, cout, cmid))
           for i in range(2, units + 1)]))


class ResNetV2(nn.Module):
    def __init__(self, units, width: int):
        super().__init__()
        w = width
        self.root = nn.Sequential(OrderedDict([
            ('conv', StdConv2d(3, w, 7, 2, 3, bias=False)),
            ('gn', nn.GroupNorm(32, w, eps=1e-6)),
            ('relu', nn.ReLU())]))
        self.body = nn.Sequential(OrderedDict([
            ('block1', _stage(w, 4 * w, w, units[0], 1)),
            ('block2', _stage(4 * w, 8 * w, 2 * w, units[1], 2)),
            ('block3', _stage(8 * w, 16 * w, 4 * w, units[2], 2))]))

    def forward(self, x):
        features = []
        in_size = x.shape[2]
        x = self.root(x)
        features.append(x)
        x = F.max_pool2d(x, kernel_size=3, stride=2, padding=0)
        for i in range(len(self.body) - 1):
            x = self.body[i](x)
            right = in_size // 4 // (i + 1)
            pad = right - x.shape[2]
            assert 0 <= pad < 3, (x.shape, right)
            features.append(F.pad(x, (0, pad, 0, pad)) if pad else x)
        x = self.body[-1](x)
        return x, features[::-1]


class Embeddings(nn.Module):
    def __init__(self, c: Dict):
        super().__init__()
        grid = c['img_size'] // 16
        self.hybrid_model = ResNetV2(c['resnet_units'], c['resnet_width'])
        self.patch_embeddings = Conv(16 * c['resnet_width'],
                                     c['hidden_size'], 1)
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, grid * grid, c['hidden_size']))
        self.dropout = Dropout(c['dropout_rate'])

    def forward(self, x):
        x, features = self.hybrid_model(x)
        x = self.patch_embeddings(x)
        x = x.flatten(2).transpose(-1, -2)
        return self.dropout(x + self.position_embeddings), features


class Attention(nn.Module):
    fp8 = False

    def __init__(self, c: Dict):
        super().__init__()
        hidden = c['hidden_size']
        self.heads = c['num_heads']
        self.head_size = hidden // self.heads
        self.query = Linear(hidden, hidden)
        self.key = Linear(hidden, hidden)
        self.value = Linear(hidden, hidden)
        self.out = Linear(hidden, hidden)
        self.attn_dropout = Dropout(c['attention_dropout_rate'])
        self.proj_dropout = Dropout(c['attention_dropout_rate'])

    def _heads(self, x):
        b, n, _ = x.shape
        return x.view(b, n, self.heads, self.head_size).permute(0, 2, 1, 3)

    def forward(self, x):
        q = _fp8(self._heads(self.query(x)), self.fp8)
        k = _fp8(self._heads(self.key(x)), self.fp8)
        v = _fp8(self._heads(self.value(x)), self.fp8)
        scores = torch.matmul(q, k.transpose(-1, -2))
        scores = scores / math.sqrt(self.head_size)
        probs = self.attn_dropout(torch.softmax(scores, dim=-1))
        ctx = torch.matmul(_fp8(probs, self.fp8), v)
        b, _, n, _ = ctx.shape
        ctx = ctx.permute(0, 2, 1, 3).reshape(b, n, -1)
        return self.proj_dropout(self.out(ctx))


class Mlp(nn.Module):
    def __init__(self, c: Dict):
        super().__init__()
        self.fc1 = Linear(c['hidden_size'], c['mlp_dim'])
        self.fc2 = Linear(c['mlp_dim'], c['hidden_size'])
        self.dropout = Dropout(c['dropout_rate'])

    def forward(self, x):
        x = self.dropout(F.gelu(self.fc1(x)))
        return self.dropout(self.fc2(x))


class Block(nn.Module):
    def __init__(self, c: Dict):
        super().__init__()
        self.attention_norm = nn.LayerNorm(c['hidden_size'], eps=1e-6)
        self.ffn_norm = nn.LayerNorm(c['hidden_size'], eps=1e-6)
        self.ffn = Mlp(c)
        self.attn = Attention(c)

    def forward(self, x):
        h = x
        x = self.attn(self.attention_norm(x)) + h
        h = x
        return self.ffn(self.ffn_norm(x)) + h


class Encoder(nn.Module):
    def __init__(self, c: Dict):
        super().__init__()
        self.layer = nn.ModuleList(Block(c) for _ in range(c['num_layers']))
        self.encoder_norm = nn.LayerNorm(c['hidden_size'], eps=1e-6)

    def forward(self, x):
        for block in self.layer:
            x = block(x)
        return self.encoder_norm(x)


class Transformer(nn.Module):
    def __init__(self, c: Dict):
        super().__init__()
        self.embeddings = Embeddings(c)
        self.encoder = Encoder(c)

    def forward(self, x):
        x, features = self.embeddings(x)
        return self.encoder(x), features


def _conv_relu(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(Conv(cin, cout, 3, padding=1, bias=False),
                         nn.BatchNorm2d(cout), nn.ReLU())


class DecoderBlock(nn.Module):
    def __init__(self, cin: int, cout: int, skip: int):
        super().__init__()
        self.conv1 = _conv_relu(cin + skip, cout)
        self.conv2 = _conv_relu(cout, cout)
        self.up = nn.UpsamplingBilinear2d(scale_factor=2)

    def forward(self, x, skip=None):
        x = self.up(x)
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        return self.conv2(self.conv1(x))


def _skips(c: Dict):
    w = c['resnet_width']
    return [s if i < c['n_skip'] else 0
            for i, s in enumerate((8 * w, 4 * w, w, 0))]


class DecoderCup(nn.Module):
    def __init__(self, c: Dict):
        super().__init__()
        self.n_skip = c['n_skip']
        channels = list(c['decoder_channels'])
        self.conv_more = _conv_relu(c['hidden_size'], HEAD_CHANNELS)
        ins = [HEAD_CHANNELS] + channels[:-1]
        self.blocks = nn.ModuleList(DecoderBlock(i, o, s) for i, o, s in
                                    zip(ins, channels, _skips(c)))

    def forward(self, hidden, features):
        b, n, c = hidden.shape
        g = math.isqrt(n)
        x = hidden.permute(0, 2, 1).contiguous().view(b, c, g, g)
        x = self.conv_more(x)
        for i, block in enumerate(self.blocks):
            x = block(x, features[i] if i < self.n_skip else None)
        return x


class Net(nn.Module):
    """TransUNet R50-ViT-B/16 of the model section's widths, in float32."""

    def __init__(self, model_cfg: Dict):
        super().__init__()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        c = _cfg(model_cfg)
        self.transformer = Transformer(c)
        self.decoder = DecoderCup(c)
        self.segmentation_head = nn.Sequential(
            Conv(c['decoder_channels'][-1], c['n_classes'], 3, padding=1),
            nn.Identity())

    def forward(self, x):
        if x.shape[1] == 1:
            x = x.repeat(1, 3, 1, 1)
        x, features = self.transformer(x)
        return self.segmentation_head(self.decoder(x, features))


def set_fp8(net: nn.Module, on: bool) -> None:
    for m in net.modules():
        if isinstance(m, (Conv, StdConv2d, Linear, Attention)):
            m.fp8 = on


def _conv_flops(cin: int, cout: int, k: int, side: int) -> int:
    return 2 * cin * cout * k * k * side * side


def attention_flops_per_slice(img: int, hidden: int = 768,
                              layers: int = 12) -> int:
    """Forward operations of attention's two products, q k^T and p v, in
    ``layers`` blocks of width ``hidden`` over the (img/16)^2 tokens of
    one img^2 slice: 2 N^2 hidden each."""
    n = (img // 16) ** 2
    return 4 * n * n * hidden * layers


def flops_per_slice(model_cfg: Dict, img: int) -> int:
    """Forward operations of one img^2 slice: every convolution (the
    standardised ones, the patch embedding, the decoder's and the head),
    every Linear layer and attention's two products. Norms, activations,
    the pool, the resizes, dropout and the weights' standardisation are
    left out (elementwise, not matrix work)."""
    c = _cfg(model_cfg)
    w, hidden = c['resnet_width'], c['hidden_size']
    total = _conv_flops(3, w, 7, img // 2)
    side = (img // 2 - 3) // 2 + 1       # after the 3x3/2 max pool
    cin = w
    for stage, units in enumerate(c['resnet_units']):
        cmid = w * 2 ** stage
        cout = 4 * cmid
        out = side if stage == 0 else (side - 1) // 2 + 1
        for u in range(units):
            first = u == 0
            ci = cin if first else cout
            total += _conv_flops(ci, cmid, 1, side if first else out)
            total += _conv_flops(cmid, cmid, 3, out)
            total += _conv_flops(cmid, cout, 1, out)
            if first and (stage > 0 or ci != cout):
                total += _conv_flops(ci, cout, 1, out)
        cin, side = cout, out
    grid = img // 16
    n = grid * grid
    total += _conv_flops(16 * w, hidden, 1, grid)
    per_layer = 4 * 2 * n * hidden * hidden + 2 * 2 * n * hidden * c[
        'mlp_dim']
    total += c['num_layers'] * per_layer
    total += attention_flops_per_slice(img, hidden, c['num_layers'])
    channels = list(c['decoder_channels'])
    total += _conv_flops(hidden, HEAD_CHANNELS, 3, grid)
    for i, (ci, co, sk) in enumerate(zip([HEAD_CHANNELS] + channels[:-1],
                                         channels, _skips(c))):
        s = grid * 2 ** (i + 1)
        total += _conv_flops(ci + sk, co, 3, s) + _conv_flops(co, co, 3, s)
    total += _conv_flops(channels[-1], c['n_classes'], 3, img)
    return total


def init_plan(shapes: Dict[str, torch.Size]) -> Dict[str, Tuple]:
    """The published init of each leaf: every convolution's weight, the
    patch embedding's and the head's bias, and the attention's Linear
    layers U(+-1/sqrt(fan_in)) (torch's default); the MLP's weights
    xavier-uniform, U(+-sqrt(6 / (fan_in + fan_out))), and biases
    N(0, 1e-6); norms' weights 1 and biases 0, BatchNorm statistics
    (0, 1) and update count 0; position embeddings 0."""
    plan = {}
    for k, s in shapes.items():
        owner, leaf = k.rsplit('.', 1)
        if leaf == 'weight' and len(s) == 4:
            plan[k] = ('uniform', math.prod(s[1:]))
        elif owner.endswith(('patch_embeddings', 'segmentation_head.0')):
            plan[k] = ('uniform', math.prod(shapes[owner + '.weight'][1:]))
        elif owner.endswith(('.ffn.fc1', '.ffn.fc2')):
            plan[k] = (('uniform', (s[0] + s[1]) / 6) if leaf == 'weight'
                       else ('normal', 1e-6))
        elif '.attn.' in k:
            plan[k] = ('uniform', shapes[owner + '.weight'][1])
        elif leaf in ('weight', 'running_var'):
            plan[k] = ('ones',)
        else:
            plan[k] = ('zeros',)
    return plan
