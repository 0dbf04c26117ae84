"""The bilinear align-corners resize as one autograd Function of one kernel
launch each way (``unet_tpu_torch/ops/resize.py``; kernels in
``unet_tpu_torch/csrc/resize.cu``), and the models' use of it.

On the CPU the kernels' index rule (``contributors``) is held against the
forward's taps inverted, for every size up to 256 doubled, and the plain
version of their arithmetic (``PlainOps``: the lerps forward, the gather
backward) against autograd through ``F.interpolate`` in float64 at every
decoder and gate shape of the three trained models, deep supervision's
2x/4x/8x and odd sizes, and against ``jax.vjp`` of the JAX package's
resize. CPU tensors keep ``F.interpolate`` and launch nothing.

Tests marked ``chip`` need the card and skip elsewhere. They import no JAX
(the JAX package is imported inside the one test that compares with it),
so they run on the card's machine, which has none, without
``tests/conftest.py``:

    python -m pytest tests/test_torch_resize.py --noconftest -m chip
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from unet_tpu_torch.models import TRANSUNET, create_model_from_config
from unet_tpu_torch.ops import resize
from unet_tpu_torch.ops._build import launches
from unet_tpu_torch.ops.resize import (PlainOps, ResizeFn, check_kernel_args,
                                       contributors, gather_matrix,
                                       pixel_stride)

REPO = Path(__file__).resolve().parent.parent
CL = torch.channels_last
U = 2.0 ** -24  # float32's unit roundoff

MODELS = {
    'unet': {'type': 'unet', 'n_channels': 1, 'n_classes': 2,
             'bilinear': True, 'base_features': 64},
    'attention_unet': {'type': 'attention_unet', 'n_channels': 1,
                       'n_classes': 2, 'bilinear': True,
                       'base_features': 64},
    'transunet': {'type': TRANSUNET, 'n_channels': 1, 'n_classes': 2},
}
# (C, h, w, out_h, out_w) of each resize a training forward makes at 512^2,
# in call order: the decoder's four 2x upsamples (TransUNet's too) and, in
# the Attention U-Net, each gate's W_g output resized before them
DECODER = [(512, 32, 32, 64, 64), (256, 64, 64, 128, 128),
           (128, 128, 128, 256, 256), (64, 256, 256, 512, 512)]
GATES = [(256, 32, 32, 64, 64), (128, 64, 64, 128, 128),
         (64, 128, 128, 256, 256), (32, 256, 256, 512, 512)]
TRAINING_CALLS = {
    'unet': DECODER,
    'attention_unet': [c for pair in zip(GATES, DECODER) for c in pair],
    'transunet': DECODER,
}
TRAINING_SHAPES = sorted(set(DECODER + GATES))
# deep supervision's 2-channel float32 maps, 2x, 4x and 8x to 512^2
DEEP = [(2, 256, 256, 512, 512), (2, 128, 128, 512, 512),
        (2, 64, 64, 512, 512)]
ODD = [(3, 17, 17, 34, 34), (5, 31, 7, 64, 14), (4, 1, 1, 5, 5),
       (2, 1, 6, 4, 13), (6, 9, 9, 9, 20)]
CPU_SHAPES = TRAINING_SHAPES + DEEP + ODD


def _ids(shapes):
    return [f'C{c}-{h}x{w}-{oh}x{ow}' for c, h, w, oh, ow in shapes]


def _most_contributors(in_size, out_size):
    return max(len(contributors(j, in_size, out_size))
               for j in range(in_size))


def _rand(shape, seed, dtype=torch.float64, device='cpu'):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(*shape, generator=g, dtype=torch.float64)
            .to(dtype).to(device).contiguous(memory_format=CL))


def _interpolate_f64(x, dy, out_h, out_w):
    """Output and dx of autograd through ``F.interpolate`` in float64."""
    x = x.detach().double().requires_grad_(True)
    y = F.interpolate(x, size=(out_h, out_w), mode='bilinear',
                      align_corners=True)
    dx, = torch.autograd.grad(y, x, dy.double())
    return y.detach(), dx


def _support(in_size, out_size):
    """(in_size, out_size): 1 where the output reaches the input."""
    m = np.zeros((in_size, out_size))
    for j in range(in_size):
        m[j, list(contributors(j, in_size, out_size))] = 1.0
    return torch.from_numpy(m)


def _bounds(x, dy, out_h, out_w, sides=1):
    """What float32 taps and sums may move, against float64 (F.interpolate
    forms the scale and the coordinates in float64): each weight by up to
    2 (n + 1) float32 roundoffs, n the larger input size (the scale's
    rounding times the index, and half an ulp of the coordinate); forward,
    that times twice max |x| on each axis, plus the lerps' few roundings;
    backward, twice that times each element's sum of |dy| over the outputs
    that reach it, plus the float32 sums' (contributors along y and x,
    plus two) roundings of the sum of the terms' magnitudes, once for each
    side that sums in float32 (``sides``)."""
    h, w = x.shape[2], x.shape[3]
    n = max(h, w) + 1
    xmax = float(x.detach().double().abs().max())
    fwd = 2 * (2 * n * U) * (2 * xmax) + sides * 8 * U * xmax
    g = dy.double().abs()
    sy, sx = _support(h, out_h), _support(w, out_w)
    wy, wx = (torch.from_numpy(gather_matrix(i, o)).double().abs()
              for i, o in ((h, out_h), (w, out_w)))
    reach = torch.einsum('jy,ncyx,kx->ncjk', sy, g, sx)
    abs_sum = torch.einsum('jy,ncyx,kx->ncjk', wy, g, wx)
    terms = _most_contributors(h, out_h) + _most_contributors(w, out_w)
    bwd = 2 * (2 * n * U) * reach + sides * (terms + 2) * U * abs_sum
    return fwd, bwd


@pytest.mark.parametrize('c,h,w,out_h,out_w', CPU_SHAPES,
                         ids=_ids(CPU_SHAPES))
def test_plain_ops_match_autograd_through_f_interpolate(c, h, w, out_h,
                                                        out_w):
    """The plain version in float32 (the kernels' arithmetic) against
    autograd through ``F.interpolate`` in float64: output and dx, one
    sample at the models' own channel counts."""
    x = _rand((1, c, h, w), seed=c + h).requires_grad_(True)
    dy = _rand((1, c, out_h, out_w), seed=w + out_w)
    y = ResizeFn.apply(x, out_h, out_w, PlainOps)
    dx, = torch.autograd.grad(y, x, dy)
    want_y, want_dx = _interpolate_f64(x, dy, out_h, out_w)
    fwd, bwd = _bounds(x, dy, out_h, out_w)
    assert y.shape == (1, c, out_h, out_w) and y.is_contiguous(
        memory_format=CL)
    assert dx.is_contiguous(memory_format=CL)
    assert float((y.detach() - want_y).abs().max()) <= fwd
    assert bool(((dx - want_dx).abs() <= bwd).all()), float(
        (dx - want_dx).abs().max())


def test_contributors_invert_the_forward_taps():
    """For every (in, 2 in) with in <= 256: the output indices the kernels'
    rule gives each input index are exactly those whose lower or upper
    tap (ATen's float32 taps) is that index."""
    for n in range(1, 257):
        out = 2 * n
        lo, hi, _ = resize._taps(n, out, 0, out, 'cpu')
        reached = [set() for _ in range(n)]
        for i, (a, b) in enumerate(zip(lo.tolist(), hi.tolist())):
            reached[a].add(i)
            reached[b].add(i)
        for j in range(n):
            assert set(contributors(j, n, out)) == reached[j], (n, j)


@pytest.mark.parametrize('c,h,w,out_h,out_w', [
    (8, 16, 16, 32, 32), (3, 17, 5, 34, 10), (2, 32, 32, 128, 128),
    (4, 1, 6, 5, 13)])
def test_plain_ops_match_jax_vjp(c, h, w, out_h, out_w):
    """The plain version against ``jax.vjp`` of the JAX package's resize
    (NHWC, its float64 tables rounded to float32 weights), output and dx
    in float32, within the bounds against float64 with both sides' float32
    roundings."""
    import jax
    import jax.numpy as jnp
    from unet_tpu.ops import resize as jresize
    x = _rand((2, c, h, w), seed=1, dtype=torch.float32)
    dy = _rand((2, c, out_h, out_w), seed=2, dtype=torch.float32)
    y, vjp = jax.vjp(
        lambda t: jresize.resize_bilinear_align_corners(t, out_h, out_w),
        jnp.asarray(x.permute(0, 2, 3, 1).numpy()))
    jdx, = vjp(jnp.asarray(dy.permute(0, 2, 3, 1).numpy()))
    xg = x.clone().requires_grad_(True)
    got = ResizeFn.apply(xg, out_h, out_w, PlainOps)
    dx, = torch.autograd.grad(got, xg, dy)
    fwd, bwd = _bounds(x, dy, out_h, out_w, sides=2)
    want_y = torch.from_numpy(np.asarray(y)).permute(0, 3, 1, 2)
    want_dx = torch.from_numpy(np.asarray(jdx)).permute(0, 3, 1, 2)
    assert float((got.detach() - want_y).abs().max()) <= fwd
    assert bool(((dx.double() - want_dx.double()).abs() <= bwd).all())


def test_plain_backward_reads_a_channel_slice_as_its_copy():
    """A dy that is a channel slice of a wider channels_last tensor (the
    decoder concat's gradient): its pixel stride is the wide tensor's, and
    the plain backward gives what it gives on a dense copy."""
    wide = _rand((2, 12, 8, 6), seed=3)
    dy = wide[:, 4:]
    assert pixel_stride(dy) == 12 and pixel_stride(dy.clone(
        memory_format=CL)) == 8
    assert pixel_stride(dy.contiguous()) is None
    assert pixel_stride(wide[:, :, :, ::2]) == 24  # pixels 24 apart
    assert pixel_stride(wide[:, :, ::2]) is None  # rows apart by two
    a = PlainOps.backward(dy, 4, 3)
    b = PlainOps.backward(dy.clone(memory_format=CL), 4, 3)
    assert torch.equal(a, b)


@pytest.mark.parametrize('what', ['downsample', 'float16', 'nchw',
                                  'channel slice', 'cpu'])
def test_kernel_args_refuse_what_the_kernels_do_not_take(what):
    x = torch.zeros(2, 16, 8, 8).contiguous(memory_format=CL)
    out, match = (16, 16), {
        'downsample': 'shrinks a dimension', 'float16': 'bfloat16 or float32',
        'nchw': 'channels_last', 'channel slice': 'elements apart',
        'cpu': 'no kernel for cpu'}[what]
    error = TypeError if what == 'float16' else ValueError
    if what == 'downsample':
        out = (16, 4)
    elif what == 'float16':
        x = x.half()
    elif what == 'nchw':
        x = x.contiguous()
    elif what == 'channel slice':
        x = torch.zeros(2, 32, 8, 8).contiguous(memory_format=CL)[:, 16:]
    with pytest.raises(error, match=match):
        check_kernel_args(x, *out)


def test_cpu_tensor_keeps_the_interpolate_route(monkeypatch):
    """A CPU tensor goes through ``F.interpolate`` (values and gradient as
    autograd gives them) and never reaches the kernels' Function."""
    def refuse(*args):
        raise AssertionError('the kernels\' Function on a CPU tensor')
    monkeypatch.setattr(ResizeFn, 'apply', refuse)
    before = dict(launches)
    x = _rand((2, 8, 5, 7), seed=4, dtype=torch.float32).requires_grad_(True)
    y = resize.upsample2x_align_corners(x)
    want = F.interpolate(x, size=(10, 14), mode='bilinear',
                         align_corners=True)
    assert torch.equal(y, want)
    assert resize.resize_bilinear_align_corners(x, 5, 7) is x
    y.sum().backward()
    assert launches == before


@pytest.mark.parametrize('name', sorted(MODELS))
def test_a_training_forward_resizes_at_these_shapes(name, monkeypatch):
    """The resizes one training forward at 512^2 makes, read on the
    ``meta`` device (where the ``F.interpolate`` route runs): the shapes
    the chip tests and ``chip_smoke.py --resize`` hold."""
    calls = []
    route = resize.interpolate_align_corners

    def recording(x, out_h, out_w):
        calls.append((*x.shape[1:], out_h, out_w))
        return route(x, out_h, out_w)
    monkeypatch.setattr(resize, 'interpolate_align_corners', recording)
    with torch.device('meta'):
        model = create_model_from_config(MODELS[name], torch.bfloat16)
        model.train()(torch.empty(4, 1, 512, 512))
    assert calls == TRAINING_CALLS[name]


def test_device_share_reader_sums_the_kernels_over_busy_time():
    """``resize.device_share`` reads the two kernels' device time over the
    busy time, and nothing where none launched (ATen's upsample kernels
    are not its)."""
    from bench_h100.tracing import TraceSummary
    path = REPO / 'bench_h100' / 'metrics' / 'resize.device_share.py'
    spec = importlib.util.spec_from_file_location('rs_share', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ours = {'void (anonymous namespace)::resize_forward<unsigned short, '
            '8>(X)': 0.02,
            'void (anonymous namespace)::resize_backward<unsigned short, '
            '8>(X)': 0.03,
            'void (anonymous namespace)::resize_backward<float, 2>(X)':
            0.001}
    aten = {'void at::native::(anonymous namespace)::upsample_bilinear2d_'
            'nhwc_out_frame<c10::BFloat16, float>(X)': 0.05,
            'void at::native::(anonymous namespace)::upsample_bilinear2d_'
            'backward_nhwc_out_frame<c10::BFloat16, float>(X)': 0.04}
    layer = {'cell': 'train'}

    def trace(ops):
        return TraceSummary(window_s=2.0, busy_s=1.0, op_seconds=ops,
                            op_counts={k: 3 for k in ops}, gaps=[])
    assert mod.read(layer, trace({**ours, **aten})) == pytest.approx(5.1)
    assert mod.read(layer, trace(aten)) is None
    assert mod.read(layer, None) is None
    assert mod.read({'cell': 'serve'}, trace(ours)) is None


# ------------------------------------------------------------ on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _kernel_both_ways(x, dy, out_h, out_w):
    """y and dx through the program's resize (the kernels)."""
    x = x.detach().clone().requires_grad_(True)
    y = resize.resize_bilinear_align_corners(x, out_h, out_w)
    dx, = torch.autograd.grad(y, x, dy)
    return y.detach(), dx


def _truth_dx(dy, h, w):
    """float64 dx with the kernels' float32 weights: what the kernels' sums
    would give without rounding."""
    out_h, out_w = dy.shape[2], dy.shape[3]
    wy, wx = (torch.from_numpy(gather_matrix(i, o)).double().to(dy.device)
              for i, o in ((h, out_h), (w, out_w)))
    return (torch.einsum('jy,ncyx,kx->ncjk', wy, dy.double(), wx),
            torch.einsum('jy,ncyx,kx->ncjk', wy.abs(), dy.double().abs(),
                         wx.abs()))


def _hold_backward(dx, dy, h, w, label):
    """dx against float64 with the same weights: float32 sums of the
    contributors along x, then along y (fused multiply-adds), err by at
    most (terms + 2) units of float32 roundoff of the sum of the terms'
    magnitudes; a bf16 result adds its rounding, at most 2^-8 of its value
    (bf16 keeps 8 significant bits)."""
    want, abs_sum = _truth_dx(dy, h, w)
    terms = (_most_contributors(h, dy.shape[2])
             + _most_contributors(w, dy.shape[3]))
    bound = (terms + 2) * U * abs_sum + (
        2.0 ** -8 * want.abs() if dx.dtype == torch.bfloat16 else 0.0)
    err = (dx.double() - want).abs()
    assert bool((err <= bound).all()), (label, float(err.max()))


@pytest.mark.chip
@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
def test_kernels_match_plain_at_every_training_shape(card, dtype):
    """Each resize shape of the three models' training forward at b4 512^2:
    the forward against the plain version on the same card tensors (the
    same float32 operations in the same order: equal in float32, within
    one bf16 rounding in bf16), the backward against float64."""
    dt = getattr(torch, dtype)
    for i, (c, h, w, out_h, out_w) in enumerate(TRAINING_SHAPES):
        x = _rand((4, c, h, w), seed=i, dtype=dt, device='cuda')
        dy = _rand((4, c, out_h, out_w), seed=50 + i, dtype=dt,
                   device='cuda')
        y, dx = _kernel_both_ways(x, dy, out_h, out_w)
        want = PlainOps.forward(x, out_h, out_w)
        label = f'C{c} {h}x{w} -> {out_h}x{out_w} {dtype}'
        assert y.is_contiguous(memory_format=CL) and dx.is_contiguous(
            memory_format=CL), label
        if dt == torch.float32:
            assert torch.equal(y, want), label
        else:
            step = 2.0 ** -7 * want.float().abs()
            assert bool(((y.float() - want.float()).abs() <= step).all()), \
                label
        _hold_backward(dx, dy, h, w, label)
    torch.cuda.empty_cache()


@pytest.mark.chip
def test_kernels_repeat_bit_for_bit(card):
    """No atomics: two runs give the same bits, forward and backward."""
    x = _rand((4, 64, 256, 256), seed=1, dtype=torch.bfloat16, device='cuda')
    dy = _rand((4, 64, 512, 512), seed=2, dtype=torch.bfloat16,
               device='cuda')
    a = _kernel_both_ways(x, dy, 512, 512)
    b = _kernel_both_ways(x, dy, 512, 512)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.chip
def test_narrow_loads_and_a_copied_gradient(card):
    """Channels or strides that do not fill 16 B take narrower loads (6
    bf16, 3 float32, a slice at an odd channel offset); a dy that does not
    lie as channels_last pixels is copied first: all against the plain
    version and float64 as at the training shapes."""
    for dt, c in ((torch.bfloat16, 6), (torch.float32, 3),
                  (torch.bfloat16, 8), (torch.float32, 2)):
        x = _rand((2, c, 9, 13), seed=c, dtype=dt, device='cuda')
        wide = _rand((2, c + 1, 18, 30), seed=9, dtype=dt, device='cuda')
        for dy in (wide[:, 1:], wide[:, 1:].contiguous()):
            y, dx = _kernel_both_ways(x, dy, 18, 30)
            want = PlainOps.forward(x, 18, 30)
            step = 2.0 ** -7 * want.float().abs() * (dt == torch.bfloat16)
            assert bool(((y.float() - want.float()).abs() <= step).all())
            _hold_backward(dx, dy, 9, 13, f'C{c} {dt}')


@pytest.mark.chip
def test_up_reads_the_concat_gradient_in_place(card, monkeypatch):
    """One bilinear ``Up`` in training (float32): its upsample's gradient
    arrives as the concat gradient's channel slice and is read there: no
    copy or elementwise kernel runs in the backward before the resize's."""
    from torch.profiler import ProfilerActivity, profile
    from unet_tpu_torch.models.layers import Up
    strides = []
    backward = resize.KernelOps.backward

    def recording(self, dy, in_h, in_w):
        strides.append(pixel_stride(dy))
        return backward(self, dy, in_h, in_w)
    monkeypatch.setattr(resize.KernelOps, 'backward', recording)
    up = Up(128, 32).to('cuda', memory_format=CL).train()
    x1 = _rand((2, 64, 32, 32), seed=5, dtype=torch.float32, device='cuda')
    x2 = _rand((2, 64, 64, 64), seed=6, dtype=torch.float32, device='cuda')
    y = up(x1.requires_grad_(True), x2)
    g = torch.ones_like(y)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        y.backward(g)
        torch.cuda.synchronize()
    names = [e.name for e in sorted(prof.events(),
                                    key=lambda e: e.time_range.start)
             if e.device_type == torch.autograd.DeviceType.CUDA]
    at = [i for i, n in enumerate(names) if 'resize_backward' in n]
    assert len(at) == 1, names
    before = [n for n in names[:at[0]]
              if 'copy' in n.lower() or 'elementwise' in n.lower()]
    assert not before, before
    assert strides == [128]


def _small(name, dtype, **over):
    """The model at 128^2 (TransUNet without dropout, so that two runs
    draw the same)."""
    cfg = dict(MODELS[name], **over)
    if name == 'transunet':
        cfg.update(img_size=128, dropout_rate=0.0)
    model = create_model_from_config(
        cfg, dtype, generator=torch.Generator().manual_seed(0))
    return model.to('cuda', memory_format=CL)


@pytest.mark.chip
@pytest.mark.parametrize('name', sorted(MODELS))
def test_train_step_launches_the_kernels_and_no_aten_upsample(card, name):
    """One TrainStep (128^2, microbatch 2 x accumulation 2) of each model:
    every resize launches the kernels once forward and once backward (4
    calls a microbatch in the U-Net and TransUNet, 8 in the Attention
    U-Net), and no ATen upsample kernel runs."""
    from torch.profiler import ProfilerActivity, profile
    from unet_tpu_torch.train.losses import create_loss_function
    from unet_tpu_torch.train.trainer import (create_optimizer,
                                              make_train_step)
    model = _small(name, torch.bfloat16).train()
    accum = 2
    step = make_train_step(model, create_loss_function('dice_bce'),
                           create_optimizer(model, 1e-3), accum_steps=accum)
    imgs = torch.randn(accum, 2, 1, 128, 128, device='cuda')
    msks = (torch.rand(accum, 2, 128, 128, device='cuda') > 0.7).long()
    step(imgs, msks, 1e-3, [1] * accum)
    before = launches['resize']
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        loss = step(imgs, msks, 1e-3, [1] * accum)
        torch.cuda.synchronize()
    assert torch.isfinite(torch.as_tensor(loss))
    calls = len(TRAINING_CALLS[name])
    assert (launches['resize'] - before
            == calls * resize.LAUNCHES_PER_CALL * accum)
    names = [e.key for e in prof.key_averages()]
    assert not [n for n in names if 'upsample_bilinear2d' in n], names
    assert any('resize_backward' in n for n in names)


@pytest.mark.chip
@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
def test_transposed_eval_and_deep_supervision_match_float64(card, dtype,
                                                            monkeypatch):
    """The transposed Attention U-Net (its gates' resizes; no upsample in
    its Up) in eval, then with deep supervision in training (the gates
    and the 2-channel float32 maps at 2x, 4x and 8x), 128^2, b2: each
    resize call's kernels on the model's own input and incoming gradient
    against ``F.interpolate`` in float64, output and dx within the bounds
    of the CPU test (float32 taps and sums) plus a bf16 step of the value
    in bf16."""
    dt = getattr(torch, dtype)
    calls = []
    forward, backward = resize.KernelOps.forward, resize.KernelOps.backward

    def fwd(self, x, out_h, out_w):
        y = forward(self, x, out_h, out_w)
        calls.append({'x': x.detach().clone(), 'y': y.detach().clone()})
        return y

    def bwd(self, dy, in_h, in_w):
        dx = backward(self, dy, in_h, in_w)
        # the call of this shape: the shapes of one model's calls differ
        rec, = [c for c in calls[4:] if c['y'].shape == dy.shape
                and c['x'].shape == dx.shape]
        rec.update(dy=dy.detach().clone(), dx=dx.detach().clone())
        return dx
    monkeypatch.setattr(resize.KernelOps, 'forward', fwd)
    monkeypatch.setattr(resize.KernelOps, 'backward', bwd)
    x = _rand((2, 1, 128, 128), seed=7, dtype=torch.float32, device='cuda')
    with torch.no_grad():
        _small('attention_unet', dt, bilinear=False).eval()(x)
    assert len(calls) == 4
    model = _small('attention_unet', dt, bilinear=False,
                   deep_supervision=True).train()
    outs = model(x)
    assert len(calls) == 4 + 4 + 3
    sum((o.float() * torch.randn_like(o.float())).sum()
        for o in outs).backward()
    assert all('dx' in c for c in calls[4:])
    for i, rec in enumerate(calls):
        rec = {k: v.cpu() for k, v in rec.items()}
        xin, y = rec['x'], rec['y']
        out_h, out_w = y.shape[2], y.shape[3]
        dy = rec.get('dy', torch.zeros_like(y))
        want_y, want_dx = _interpolate_f64(xin, dy, out_h, out_w)
        fwd_b, bwd_b = _bounds(xin, dy, out_h, out_w)
        step = 2.0 ** -8 if xin.dtype == torch.bfloat16 else 0.0
        err = (y.double() - want_y).abs()
        assert bool((err <= fwd_b + step * want_y.abs()).all()), (
            i, tuple(xin.shape), float(err.max()))
        if 'dx' in rec:
            err = (rec['dx'].double() - want_dx).abs()
            assert bool((err <= bwd_b + step * want_dx.abs()).all()), (
                i, tuple(xin.shape), float(err.max()))
