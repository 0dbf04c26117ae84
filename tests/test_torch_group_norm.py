"""GroupNorm (+ReLU) on channels_last maps as one autograd Function of two
passes each way (``unet_tpu_torch/ops/group_norm.py``; kernels in
``unet_tpu_torch/csrc/group_norm.cu``), and TransUNet's use of it.

On the CPU the plain passes (``PlainPasses``) are held, in float64, against
autograd through ``F.group_norm`` (+``torch.relu``): output, dx, dweight
and dbias, at 1 channel a group (eps 1e-5, as ``gn_proj``), 2, 8 and 32
(eps 1e-6) and on an odd 5x7 map, with and without the ReLU; in float32
they keep the variance of a group whose mean is a thousand times its
spread. TransUNet's CPU tensors keep ``F.group_norm`` and launch nothing;
its state dict and its 52 GroupNorm calls at the published widths are
read on the ``meta`` device.

Tests marked ``chip`` need the card and skip elsewhere. This file imports
no JAX, so they run on the card's machine, which has none, without
``tests/conftest.py``:

    python -m pytest tests/test_torch_group_norm.py --noconftest -m chip
"""

import importlib.util
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from unet_tpu_torch.models import TRANSUNET, create_model_from_config
from unet_tpu_torch.models import transunet as tu
from unet_tpu_torch.ops import group_norm as gn_ops
from unet_tpu_torch.ops._build import launches
from unet_tpu_torch.ops.group_norm import (GroupNormFn, PlainPasses,
                                           check_kernel_args)

REPO = Path(__file__).resolve().parent.parent
CL = torch.channels_last
PUBLISHED = {'type': TRANSUNET, 'n_channels': 1, 'n_classes': 2}

# (C, G, H, W, eps): channels per group 1 (gn_proj's eps), 2, 8, 32, and an
# odd map (as the 127^2 of stage 1)
SHAPES = [(16, 16, 4, 6, 1e-5), (16, 8, 4, 6, 1e-6), (32, 4, 4, 6, 1e-6),
          (64, 2, 4, 6, 1e-6), (24, 8, 5, 7, 1e-6)]
CASES = [(*s, relu) for s in SHAPES for relu in (False, True)]
IDS = [f'C{c}-G{g}-{h}x{w}-{"relu" if relu else "plain"}'
       for c, g, h, w, _, relu in CASES]
# float64 on both sides: the closed form and autograd agree to rounding
F64 = dict(rtol=1e-9, atol=1e-10)

# TransUNet's 52 GroupNorm calls a forward at b4 512^2: (C, H, W, G, eps,
# relu) and how many calls of each
TRANSUNET_CALLS = {
    (64, 256, 256, 32, 1e-6, True): 1,        # root
    (64, 127, 127, 32, 1e-6, True): 6,        # stage 1 gn1, gn2
    (256, 127, 127, 32, 1e-6, False): 3,      # stage 1 gn3
    (256, 127, 127, 256, 1e-5, False): 1,     # stage 1 gn_proj
    (128, 127, 127, 32, 1e-6, True): 1,       # stage 2 unit 1 gn1
    (128, 64, 64, 32, 1e-6, True): 7,         # stage 2 gn2, gn1 of 2-4
    (512, 64, 64, 32, 1e-6, False): 4,        # stage 2 gn3
    (512, 64, 64, 512, 1e-5, False): 1,       # stage 2 gn_proj
    (256, 64, 64, 32, 1e-6, True): 1,         # stage 3 unit 1 gn1
    (256, 32, 32, 32, 1e-6, True): 17,        # stage 3 gn2, gn1 of 2-9
    (1024, 32, 32, 32, 1e-6, False): 9,       # stage 3 gn3
    (1024, 32, 32, 1024, 1e-5, False): 1,     # stage 3 gn_proj
}


def _case(c, h, w, seed, n=4, dtype=torch.float64, device='cpu',
          centre=1.0, spread=3.0):
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float64)

    return dict(
        x=(spread * rnd(n, c, h, w) + centre).to(dtype).to(device)
        .contiguous(memory_format=CL),
        dy=rnd(n, c, h, w).to(dtype).to(device).contiguous(memory_format=CL),
        weight=(rnd(c).abs() + 0.5).to(dtype).to(device),
        bias=rnd(c).to(dtype).to(device))


def _autograd(case, groups, eps, relu):
    """Autograd through ``F.group_norm`` (+``torch.relu``)."""
    x = case['x'].clone().requires_grad_(True)
    w = case['weight'].clone().requires_grad_(True)
    b = case['bias'].clone().requires_grad_(True)
    y = F.group_norm(x, groups, w, b, eps)
    if relu:
        y = torch.relu(y)
    (y * case['dy']).sum().backward()
    return dict(y=y.detach(), dx=x.grad, dweight=w.grad, dbias=b.grad)


def _function(case, groups, eps, relu, plain=True):
    """The Function on ``case``: the plain passes, or (``plain`` false,
    CUDA tensors) the kernels through ``group_norm``."""
    x = case['x'].clone().requires_grad_(True)
    w = case['weight'].clone().requires_grad_(True)
    b = case['bias'].clone().requires_grad_(True)
    if plain:
        y = GroupNormFn.apply(x, w, b, groups, eps, relu, PlainPasses)
    else:
        y = gn_ops.group_norm(x, groups, w, b, eps, relu)
    (y * case['dy']).sum().backward()
    return dict(y=y.detach(), dx=x.grad, dweight=w.grad, dbias=b.grad)


@pytest.mark.parametrize('c,groups,h,w,eps,relu', CASES, ids=IDS)
def test_plain_passes_match_autograd_through_f_group_norm(c, groups, h, w,
                                                          eps, relu):
    case = _case(c, h, w, seed=c + groups + relu)
    want = _autograd(case, groups, eps, relu)
    got = _function(case, groups, eps, relu)
    for k in ('y', 'dx', 'dweight', 'dbias'):
        assert got[k].dtype == torch.float64, k
        torch.testing.assert_close(got[k], want[k], **F64, msg=k)
    assert got['y'].is_contiguous(memory_format=CL)
    assert got['dx'].is_contiguous(memory_format=CL)
    if relu:
        assert (want['y'] == 0).float().mean() > 0.2   # the mask bites


def test_plain_passes_keep_the_variance_of_a_far_off_mean():
    """float32, each group's mean a thousand times its spread: the sums
    about each map's first pixel keep mean and rstd to float32 rounding
    (E[x^2] - mean^2 in float32 would lose the variance to cancellation)."""
    case = _case(32, 8, 8, seed=5, dtype=torch.float32, centre=1000.0,
                 spread=1.0)
    x = case['x']
    sc = PlainPasses.stats_finalize(x, case['weight'], case['bias'], 8, 1e-6)
    _, _, mean, rstd = gn_ops._unpack(sc, x, 8)
    groups = x.double().reshape(4, 8, -1)
    want_mean = groups.mean(2)
    want_rstd = torch.rsqrt(groups.var(2, unbiased=False) + 1e-6)
    torch.testing.assert_close(mean.double(), want_mean, rtol=2e-7, atol=0)
    torch.testing.assert_close(rstd.double(), want_rstd, rtol=1e-4, atol=0)
    naive = (x.reshape(4, 8, -1) ** 2).mean(2) - mean ** 2
    assert float((naive - 1 / want_rstd.float() ** 2).abs().max()) > 1e-2


def test_cpu_tensor_keeps_the_eager_path(monkeypatch):
    """TransUNet's GroupNorm on a CPU tensor runs ``F.group_norm`` (then
    the fused ReLU's ``torch.relu``), never the kernels' wrapper, and
    launches nothing."""
    def refuse(*a, **k):
        raise AssertionError('a CPU tensor reached group_norm')

    monkeypatch.setattr(tu, 'group_norm', refuse)
    before = launches['group_norm']
    case = _case(16, 5, 7, seed=3, dtype=torch.float32)
    for relu in (False, True):
        m = tu.GroupNorm(8, 16, eps=1e-6, relu=relu)
        with torch.no_grad():
            m.weight.copy_(case['weight'])
            m.bias.copy_(case['bias'])
            y = m(case['x'])
        want = F.group_norm(case['x'], 8, case['weight'], case['bias'], 1e-6)
        if relu:
            want = torch.relu(want)
        torch.testing.assert_close(y, want, rtol=0, atol=0)
        assert y.is_contiguous(memory_format=CL)
    assert launches['group_norm'] == before


@pytest.mark.parametrize('what', ['float16', 'float64', 'nchw', '3d', 'cpu',
                                  'groups', 'weight'])
def test_kernels_refuse_other_dtypes_layouts_and_devices(what):
    x = torch.randn(2, 8, 4, 4).contiguous(memory_format=CL)
    groups, vec = 4, torch.zeros(8)
    if what in ('float16', 'float64'):
        x = x.to(getattr(torch, what))
    elif what == 'nchw':
        x = torch.randn(2, 8, 4, 4)
    elif what == '3d':
        x = torch.randn(8, 4, 4)
    elif what == 'groups':
        x = torch.randn(1, 512, 2, 2).contiguous(memory_format=CL)
        groups, vec = 1, torch.zeros(512)   # 512 channels a group
    elif what == 'weight':
        vec = torch.zeros(8, dtype=torch.bfloat16)
    error = TypeError if what.startswith('float') else ValueError
    with pytest.raises(error):
        check_kernel_args(x, groups, vec, vec)


def _calls(model, x):
    """(C, H, W, G, eps, relu) of every GroupNorm call of ``model(x)``, in
    call order."""
    calls = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, inp: calls.append((*inp[0].shape[1:], mod.num_groups,
                                       mod.eps, mod.relu)))
        for m in model.modules() if isinstance(m, tu.GroupNorm)]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return calls


def _published_calls():
    """The GroupNorm calls of the published TransUNet's encoder CNN (every
    GroupNorm of the model) at b4 512^2, read on the ``meta`` device."""
    with torch.device('meta'):
        model = create_model_from_config(PUBLISHED, torch.bfloat16)
        x = torch.empty(4, 3, 512, 512, dtype=torch.bfloat16).contiguous(
            memory_format=CL)
    return _calls(model.transformer.embeddings.hybrid_model, x)


def test_state_dict_keys_unchanged_and_relu_fused_where_published():
    """The published names (the root's ReLU at ``root.relu`` is an
    Identity, without state); the ReLU fused into the root's GroupNorm and
    each bottleneck's gn1 and gn2, not into gn3 (the residual add comes
    first) or gn_proj."""
    import sys
    sys.path.insert(0, str(REPO / 'tests'))
    import plain_transunet as ref
    with torch.device('meta'):
        prog = create_model_from_config(PUBLISHED, torch.bfloat16)
        net = ref.Net(PUBLISHED)
    assert list(prog.state_dict()) == list(net.state_dict())
    root = prog.transformer.embeddings.hybrid_model.root
    assert isinstance(root.relu, torch.nn.Identity) and root.gn.relu
    for name, m in prog.named_modules():
        if isinstance(m, tu.GroupNorm):
            assert m.relu == name.endswith(('.gn', '.gn1', '.gn2')), name


def test_transunet_runs_52_group_norms_at_the_published_widths():
    calls = _published_calls()
    assert len(calls) == 52
    counts = {}
    for call in calls:
        counts[call] = counts.get(call, 0) + 1
    assert counts == TRANSUNET_CALLS


def test_device_share_reader_sums_the_kernels_over_busy_time():
    """``group_norm.device_share`` reads the six kernels' device time over
    the busy time, and nothing where none launched (ATen's GroupNorm
    kernels are not its)."""
    from bench_h100.tracing import TraceSummary
    path = REPO / 'bench_h100' / 'metrics' / 'group_norm.device_share.py'
    spec = importlib.util.spec_from_file_location('gn_share', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ours = {'void (anonymous namespace)::group_norm_stats<unsigned short, '
            '8>(X)': 0.02,
            'void (anonymous namespace)::group_norm_grad_input<unsigned '
            'short, 8>(X)': 0.03,
            'void (anonymous namespace)::group_norm_grad_finalize<unsigned '
            'short>(X)': 0.001}
    aten = {'void at::native::(anonymous namespace)::RowwiseMomentsCUDAKe'
            'rnel<c10::BFloat16>(X)': 0.05,
            'void at::native::(anonymous namespace)::ComputeInternalGradie'
            'ntsCUDAKernel<c10::BFloat16>(X)': 0.04}
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


def _group_view(t, groups):
    n = t.shape[0]
    return t.reshape(n, groups, -1)


def _per_element(v, shape, groups):
    """A per-(sample, group) value (N, G) broadcast over (N, C, H, W)."""
    n, c, h, w = shape
    return v.repeat_interleave(c // groups, 1)[:, :, None, None].expand(
        n, c, h, w)


def _truth(case, groups, eps):
    """float64 mean and rstd per (sample, group), NCHW-ordered groups."""
    x = case['x'].double().contiguous()
    g = _group_view(x, groups)
    mean = g.mean(2)
    rstd = torch.rsqrt(g.var(2, unbiased=False) + eps)
    return mean, rstd


def _undecided(case, groups, eps, relu):
    """Where the ReLU's mask is not decided by the statistics: the
    pre-activation (float64) within 1e-5 of 0. The kernels and the plain
    passes form mean and rstd in another order and the kernels form a * x
    + b with one FMA where the plain passes round twice; that moves a
    pre-activation by up to ~1e-6 and can flip the mask there."""
    x = case['x'].double()
    if not relu:
        return torch.zeros_like(x, dtype=torch.bool)
    mean, rstd = _truth(case, groups, eps)
    pre = ((x - _per_element(mean, x.shape, groups))
           * _per_element(rstd, x.shape, groups)
           * case['weight'].double().view(1, -1, 1, 1)
           + case['bias'].double().view(1, -1, 1, 1))
    return pre.abs() < 1e-5


def _flip_room(case, groups, eps, undecided):
    """What flipping the mask at the undecided elements can move: per
    channel dbias by sum |dy| there and dweight by sum |dy * xhat| there;
    per (sample, group) A and B by sum |w dy| / M and sum |w dy xhat| / M,
    and through them every dx element of the group by rstd * (room of A
    + |xhat| * room of B)."""
    x = case['x'].double()
    n, c, h, w = x.shape
    mean, rstd = _truth(case, groups, eps)
    xhat = ((x - _per_element(mean, x.shape, groups))
            * _per_element(rstd, x.shape, groups))
    dy = case['dy'].double().abs() * undecided
    wv = case['weight'].double().abs().view(1, -1, 1, 1)
    room = {'dbias': dy.sum((0, 2, 3)),
            'dweight': (dy * xhat.abs()).sum((0, 2, 3))}
    m = h * w * (c // groups)
    ra = _group_view((wv * dy).contiguous(), groups).sum(2) / m
    rb = _group_view((wv * dy * xhat.abs()).contiguous(), groups).sum(2) / m
    room['dx'] = _per_element(rstd, x.shape, groups) * (
        _per_element(ra, x.shape, groups)
        + xhat.abs() * _per_element(rb, x.shape, groups))
    return room


def _within_bf16(got, want, msg, room=0.0):
    """Equal but for a bf16 step: the statistics' summation order moves
    a and b by float32 rounding, which can flip the bf16 rounding of a
    value; the second term covers values near zero after cancellation;
    ``room`` what flipped masks elsewhere can move."""
    got, want = got.float(), want.float()
    bound = want.abs() * 2.0 ** -7 + 1e-3 * want.abs().max() + room
    bad = (got - want).abs() > bound
    assert not bad.any(), (msg, int(bad.sum()), float(
        (got - want).abs().max()))


def _hold_kernels_at(c, h, w, groups, eps, relu, dtype, seed):
    """The kernels against the plain passes, forward and backward, at (C,
    H, W, G) with batch 4, on the same card tensors."""
    dt = getattr(torch, dtype)
    case = _case(c, h, w, seed=seed, dtype=dt, device='cuda')
    got = _function(case, groups, eps, relu, plain=False)
    want = _function(case, groups, eps, relu)
    label = f'C{c} {h}x{w} G{groups} relu={relu} {dtype}'
    held = ~_undecided(case, groups, eps, relu)
    assert held.float().mean() > 0.999, label
    room = _flip_room(case, groups, eps, ~held)
    for k in ('y', 'dx'):
        a, b = got[k][held], want[k][held]
        extra = room['dx'][held].float() if k == 'dx' else 0.0
        if dt == torch.bfloat16:
            _within_bf16(a, b, f'{label} {k}', extra)
        else:
            # float32 on both sides; only the order of the sums differs
            err = (a - b).abs()
            bad = err > 1e-4 + 1e-4 * b.abs() + extra
            assert not bad.any(), (label, k, int(bad.sum()),
                                   float(err.max()))
    for k in ('dweight', 'dbias'):
        assert got[k].dtype == dt, (label, k)
        # float32 sums of up to 2^18 terms in two orders, against the
        # largest channel's magnitude, plus a bf16 step of the result and
        # what a flipped mask at the undecided elements can move
        scale = float(want[k].float().abs().max()) + 1.0
        err = (got[k].double() - want[k].double()).abs()
        bad = err > (1e-4 * scale + 2.0 ** -7 * want[k].double().abs()
                     * (dt == torch.bfloat16) + room[k])
        assert not bad.any(), (label, k, float(err.max()), scale)
    assert got['y'].is_contiguous(memory_format=CL)
    assert got['dx'].is_contiguous(memory_format=CL)


@pytest.mark.chip
@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
def test_kernels_match_plain_at_every_transunet_shape(card, dtype):
    """Each of TransUNet's 12 GroupNorm shapes at b4 512^2, read from the
    model, with and without the ReLU: the kernels against the plain
    passes on the same card tensors."""
    calls = _published_calls()
    assert len(set(calls)) == 12
    for i, (c, h, w, groups, eps, _) in enumerate(sorted(set(calls))):
        for relu in (False, True):
            _hold_kernels_at(c, h, w, groups, eps, relu, dtype, seed=i)
    torch.cuda.empty_cache()


@pytest.mark.chip
def test_kernels_repeat_bit_for_bit(card):
    """No atomics: two runs of a call give the same bits, forward and
    backward."""
    case = _case(256, 127, 127, seed=1, dtype=torch.bfloat16, device='cuda')
    a = _function(case, 32, 1e-6, True, plain=False)
    b = _function(case, 32, 1e-6, True, plain=False)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _off_a_load(t):
    """t's values in a channels_last tensor whose data starts one element
    past a 16-B boundary."""
    n, c, h, w = t.shape
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    off = flat[1:].view(n, h, w, c).permute(0, 3, 1, 2)
    off.copy_(t)
    assert off.is_contiguous(memory_format=CL) and off.data_ptr() % 16
    return off


@pytest.mark.chip
def test_kernels_refuse_partial_loads_and_take_an_unaligned_gradient(
        card, monkeypatch):
    """The kernels load 16 B along C: channels that do not fill whole loads
    (12 bf16, 6 float32), an x that starts off a load's boundary and
    groups wider than the library takes are refused; a dy that starts off
    a load's boundary is copied and gives the aligned dy's result bit for
    bit."""
    for dt, c in ((torch.bfloat16, 12), (torch.float32, 6)):
        x = torch.randn(2, c, 4, 4, device='cuda').to(dt).contiguous(
            memory_format=CL)
        vec = torch.ones(c, dtype=dt, device='cuda')
        with pytest.raises(ValueError, match='whole loads'):
            check_kernel_args(x, c // 3, vec, vec)
    case = _case(64, 8, 8, seed=3, dtype=torch.bfloat16, device='cuda')
    vec = case['weight']
    with pytest.raises(ValueError, match='whole loads'):
        check_kernel_args(_off_a_load(case['x']), 32, vec, vec)
    wide = torch.zeros(1, 512, 2, 2, dtype=torch.bfloat16,
                       device='cuda').contiguous(memory_format=CL)
    ones = torch.ones(512, dtype=torch.bfloat16, device='cuda')
    with pytest.raises(ValueError, match='at most 256 channels'):
        check_kernel_args(wide, 1, ones, ones)
    seen = []
    incoming = gn_ops.KernelPasses.incoming

    def recording(self, dy, x):
        seen.append(dy.data_ptr() % 16)
        return incoming(self, dy, x)
    monkeypatch.setattr(gn_ops.KernelPasses, 'incoming', recording)
    grads = []
    for dy in (case['dy'], _off_a_load(case['dy'])):
        x = case['x'].clone().requires_grad_(True)
        w = case['weight'].clone().requires_grad_(True)
        b = case['bias'].clone().requires_grad_(True)
        y = gn_ops.group_norm(x, 32, w, b, 1e-6, True)
        grads.append(torch.autograd.grad(y, (x, w, b), dy))
    assert seen[0] == 0 and seen[1] != 0, seen
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def _small_transunet(dtype):
    """The published widths at 128^2, without dropout (two runs of one
    model draw the same)."""
    cfg = dict(PUBLISHED, img_size=128, dropout_rate=0.0)
    model = create_model_from_config(
        cfg, dtype, generator=torch.Generator().manual_seed(0))
    return model.to('cuda', memory_format=CL)


@pytest.mark.chip
def test_train_step_launches_every_group_norm_without_layout_copies(
        card, monkeypatch):
    """One TransUNet TrainStep (published widths at 128^2, microbatch 2 x
    accumulation 2): 52 GroupNorm calls a microbatch, each launching the
    kernels once forward and once backward, every gradient arriving in
    channels_last (no copy between layouts)."""
    from unet_tpu_torch.train.losses import create_loss_function
    from unet_tpu_torch.train.trainer import (create_optimizer,
                                              make_train_step)
    layouts = []
    backward = GroupNormFn.backward

    def recording(ctx, dy):
        layouts.append(dy.is_contiguous(memory_format=CL))
        return backward(ctx, dy)
    monkeypatch.setattr(GroupNormFn, 'backward', staticmethod(recording))
    model = _small_transunet(torch.bfloat16).train()
    accum = 2
    step = make_train_step(model, create_loss_function('dice_bce'),
                           create_optimizer(model, 1e-3), accum_steps=accum)
    imgs = torch.randn(accum, 2, 1, 128, 128, device='cuda')
    msks = (torch.rand(accum, 2, 128, 128, device='cuda') > 0.7).long()
    before = launches['group_norm']
    loss = step(imgs, msks, 1e-3, [1] * accum)
    torch.cuda.synchronize()
    assert torch.isfinite(torch.as_tensor(loss))
    assert (launches['group_norm'] - before
            == 52 * gn_ops.LAUNCHES_PER_CALL * accum)
    assert len(layouts) == 52 * accum and all(layouts)


def _aten(x, groups, weight, bias, eps, relu):
    """ATen's GroupNorm (+ReLU) with the layout copy back to channels_last:
    the route the model took before the kernels."""
    y = F.group_norm(x, groups, weight, bias, eps).contiguous(
        memory_format=CL)
    return torch.relu(y) if relu else y


@pytest.mark.chip
def test_every_encoder_call_matches_float64(card, monkeypatch):
    """float32 (TF32 off): TransUNet's ResNet encoder, which holds all 52
    GroupNorms, at the published widths and 128^2, b2. Each call's
    kernels on the encoder's own input, weights and incoming gradient,
    against ``F.group_norm`` (+ReLU) in float64: output, dx, dweight and
    dbias within 1e-5 of the largest element (beside what a ReLU mask
    flipped at an undecided element can move); the encoder's map and
    skips against the ATen route within 1e-4. (The encoder's parameter
    gradients are not compared between routes: at 8x8 maps a ReLU mask or
    a max-pool choice that float32 rounding flips moves a stage-3 conv's
    gradient by up to a fifth on either route, measured against
    float64.) Eval mode launches the forward kernels alone."""
    monkeypatch.setattr(torch.backends.cudnn, 'deterministic', True)
    model = _small_transunet(torch.float32).train()
    cnn = model.transformer.embeddings.hybrid_model
    gen = torch.Generator(device='cuda').manual_seed(2)
    x = torch.randn(2, 3, 128, 128, device='cuda', generator=gen).contiguous(
        memory_format=CL)
    with torch.no_grad():
        out, skips = cnn(x)
    probes = [torch.randn(t.shape, device='cuda', generator=gen)
              for t in (out, *skips)]
    calls = []

    def pre(mod, inp):
        calls.append({'mod': mod, 'x': inp[0].detach().clone()})

    def post(mod, inp, y):
        rec = calls[-1]
        y.register_hook(lambda g: rec.update(dy=g.detach().clone()))
    hooks = [h for m in cnn.modules() if isinstance(m, tu.GroupNorm)
             for h in (m.register_forward_pre_hook(pre),
                       m.register_forward_hook(post))]
    got = cnn(x)
    sum((t * p).sum() for t, p in zip((got[0], *got[1]), probes)).backward()
    for h in hooks:
        h.remove()
    with monkeypatch.context() as m, torch.no_grad():
        m.setattr(tu, 'group_norm', _aten)
        want = cnn(x)
    for a, b in zip((got[0], *got[1]), (want[0], *want[1])):
        torch.testing.assert_close(a.detach(), b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))
    assert len(calls) == 52
    assert sum(c['mod'].relu for c in calls) == 1 + 2 * 16
    for i, c in enumerate(calls):
        mod = c['mod']
        case = dict(x=c['x'], dy=c['dy'], weight=mod.weight.detach(),
                    bias=mod.bias.detach())
        args = (mod.num_groups, mod.eps, mod.relu)
        kernels = _function(case, *args, plain=False)
        truth = _autograd({k: v.double() for k, v in case.items()}, *args)
        held = ~_undecided(case, *args)
        room = _flip_room(case, mod.num_groups, mod.eps, ~held)
        for k in ('y', 'dx'):
            a, b = kernels[k][held].double(), truth[k][held]
            extra = room['dx'][held] if k == 'dx' else 0.0
            bad = (a - b).abs() > 1e-5 * float(truth[k].abs().max()) + extra
            assert not bad.any(), (i, k, int(bad.sum()))
        for k in ('dweight', 'dbias'):
            err = (kernels[k].double() - truth[k]).abs()
            bad = err > 1e-5 * float(truth[k].abs().max()) + room[k]
            assert not bad.any(), (i, k, float(err.max()))
    model.eval()
    before = launches['group_norm']
    with torch.no_grad():
        model(x[:, :1])
    torch.cuda.synchronize()
    assert launches['group_norm'] - before == 52 * 3
