"""The port's 3x3 implicit-GEMM conv (unet_tpu_torch/ops/conv3x3.py)
against the JAX package's Pallas kernel in interpret mode, on the same
numpy inputs. On the CPU the port's wrapper runs its plain version; the
CUDA kernel itself runs only on a GPU, where chip_smoke.py holds it
against that plain version at every conv shape of AttentionUNet-64.

Tolerances: float32 at the JAX golden tests' 1e-4 (tests/test_pallas_conv.py),
gradients dx 1e-4 and dk 1e-3 as there. bfloat16 is held tighter than
that file's atol 0.15 / rtol 0.1 against XLA: both sides round x and k
to bf16, sum exact products in f32 and round once, so they differ only
where another f32 summation order moves the value across a bf16 rounding
boundary: at most one bf16 step, 2^-7 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_tpu.ops.pallas import conv3x3 as jconv
from unet_tpu_torch.ops import conv3x3 as conv
from unet_tpu_torch.ops._build import launches

torch.set_num_threads(2)

# tests/test_pallas_conv.py's LEVEL_SHAPES: (n, h, w, cin, cout)
LEVEL_SHAPES = [
    (2, 16, 128, 64, 64),
    (1, 8, 128, 64, 128),
    (1, 8, 128, 128, 128),
    (1, 8, 128, 128, 64),
    (1, 8, 128, 256, 128),
]

# every 3x3 conv of AttentionUNet-64 at 512^2 with Cin, Cout >= 64:
# (spatial size, cin, cout)
MODEL_CONVS = [
    (512, 64, 64), (512, 128, 64), (512, 64, 64),
    (256, 64, 128), (256, 128, 128), (256, 256, 128), (256, 128, 64),
    (128, 128, 256), (128, 256, 256), (128, 512, 256), (128, 256, 128),
    (64, 256, 512), (64, 512, 512), (64, 1024, 512), (64, 512, 256),
    (32, 512, 512), (32, 512, 512),
]

BF16_RTOL = 2.0 ** -7


def _inputs(rng, n, h, w, ci, co):
    x = rng.standard_normal((n, h, w, ci), dtype=np.float32)
    k = rng.standard_normal((3, 3, ci, co), dtype=np.float32) * 0.1
    return x, k


def _nchw(a, dtype=torch.float32):
    return torch.from_numpy(a).permute(0, 3, 1, 2).to(
        dtype=dtype, memory_format=torch.channels_last)


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).detach().numpy()


@pytest.mark.parametrize('n,h,w,ci,co', LEVEL_SHAPES)
def test_forward_matches_pallas_interpret(n, h, w, ci, co, rng):
    x, k = _inputs(rng, n, h, w, ci, co)
    want = np.asarray(jconv.conv3x3(jnp.asarray(x), jnp.asarray(k), True))
    got = conv.conv3x3(_nchw(x), torch.from_numpy(k))
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-4, atol=1e-4)


def test_forward_bf16_matches_pallas_interpret(rng):
    x, k = _inputs(rng, 1, 16, 128, 64, 64)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jconv.conv3x3(xb, jnp.asarray(k), True), np.float32)
    got = conv.conv3x3(_nchw(x, torch.bfloat16), torch.from_numpy(k))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_nhwc(got), want, rtol=BF16_RTOL, atol=1e-6)
    # the x -> bf16 rounding happened before the products: the f32 route
    # on the same rounded input gives the same values up to that step
    ref = conv.conv3x3_plain(_nchw(x, torch.bfloat16).float(),
                             torch.from_numpy(k).bfloat16().float())
    np.testing.assert_allclose(_nhwc(got), _nhwc(ref), rtol=BF16_RTOL,
                               atol=1e-6)


def test_gradients_match_jax_custom_vjp(rng):
    x, k = _inputs(rng, 1, 16, 128, 64, 64)

    def loss(xx, kk):
        return jnp.sum(jnp.sin(jconv.conv3x3(xx, kk, True)))

    gx, gk = jax.grad(loss, (0, 1))(jnp.asarray(x), jnp.asarray(k))
    xt = _nchw(x).requires_grad_(True)
    kt = torch.from_numpy(k).requires_grad_(True)
    torch.sin(conv.conv3x3(xt, kt)).sum().backward()
    assert kt.grad.dtype == torch.float32 and kt.grad.shape == k.shape
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(gx), atol=1e-4)
    np.testing.assert_allclose(kt.grad.numpy(), np.asarray(gk), atol=1e-3)


def test_bf16_weight_gradient_comes_back_in_f32(rng):
    x, k = _inputs(rng, 1, 8, 16, 64, 64)
    xt = _nchw(x, torch.bfloat16).requires_grad_(True)
    kt = torch.from_numpy(k).requires_grad_(True)
    conv.conv3x3(xt, kt).float().square().sum().backward()
    assert xt.grad.dtype == torch.bfloat16 and kt.grad.dtype == torch.float32
    assert torch.isfinite(kt.grad).all() and kt.grad.abs().sum() > 0


def test_fold_bn_scale_shift_matches_jax(rng):
    c = 64
    scale = rng.random(c, dtype=np.float32) + 0.5
    bias = rng.standard_normal(c, dtype=np.float32)
    mean = rng.standard_normal(c, dtype=np.float32)
    var = rng.random(c, dtype=np.float32) + 0.1
    arrays = (scale, bias, mean, var)
    wm, wa = jconv.fold_bn_scale_shift(*map(jnp.asarray, arrays))
    gm, ga = conv.fold_bn_scale_shift(*map(torch.from_numpy, arrays))
    assert gm.dtype == ga.dtype == torch.float32
    # rsqrt may differ by an ulp between XLA and ATen
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), rtol=1e-6)
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize('relu', [True, False])
def test_bn_relu_epilogue_matches_pallas_interpret(relu, rng):
    x, k = _inputs(rng, 1, 8, 128, 64, 64)
    c = k.shape[3]
    scale = (rng.standard_normal(c, dtype=np.float32) * 0.1 + 1.0)
    bias = rng.standard_normal(c, dtype=np.float32) * 0.1
    mean = rng.standard_normal(c, dtype=np.float32) * 0.1
    var = np.abs(rng.standard_normal(c, dtype=np.float32)) + 0.5
    jm, ja = jconv.fold_bn_scale_shift(*map(jnp.asarray,
                                            (scale, bias, mean, var)))
    want = np.asarray(jconv.conv3x3_bn_relu(
        jnp.asarray(x), jnp.asarray(k), jm, ja, relu=relu, interpret=True))
    mul, add = conv.fold_bn_scale_shift(
        *map(torch.from_numpy, (scale, bias, mean, var)))
    got = conv.conv3x3_bn_relu(_nchw(x), torch.from_numpy(k), mul, add,
                               relu=relu)
    assert not got.requires_grad
    np.testing.assert_allclose(_nhwc(got), want, atol=1e-4)
    assert (got.min() >= 0) == relu


def test_guard_accepts_what_jax_accepts_and_lists_the_differences():
    """Every shape the JAX guard takes, the port takes. They differ only
    where the TPU's tiling refuses: the 64^2 and 32^2 levels (W not a
    multiple of 128), H not a multiple of 8, and, in float32, the shapes
    whose row tiles overflow the TPU's VMEM budget."""
    cases = [((8, s, s, ci), (3, 3, ci, co)) for s, ci, co in MODEL_CONVS]
    cases += [((1, 12, 128, 64, ), (3, 3, 64, 64)),
              ((1, 16, 100, 64), (3, 3, 64, 64)),
              ((1, 16, 256, 64), (3, 3, 64, 64))]
    differ = {2: set(), 4: set()}
    for itemsize in (2, 4):
        for xs, ks in cases:
            want = jconv.igemm_shapes_supported(xs, ks, itemsize=itemsize)
            n, h, w, ci = xs
            got = conv.igemm_shapes_supported((n, ci, h, w), ks, itemsize)
            assert got or not want, (xs, ks)
            if got != want:
                differ[itemsize].add((h, w, ci, ks[3]))
    deep = {(s, s, ci, co) for s, ci, co in MODEL_CONVS if s <= 64}
    odd = {(12, 128, 64, 64), (16, 100, 64, 64)}
    assert differ[2] == deep | odd
    vmem_f32 = {(512, 512, 64, 64), (512, 512, 128, 64),
                (128, 128, 512, 256)}
    assert differ[4] == deep | odd | vmem_f32


def test_guard_accepts_every_attention_unet64_conv_and_rejects_the_rest():
    for s, ci, co in MODEL_CONVS:
        assert conv.igemm_shapes_supported((8, ci, s, s), (3, 3, ci, co))
        assert conv.igemm_shapes_supported((4, co, s, s), (3, 3, co, ci))
    refused = [((8, 1, 512, 512), (3, 3, 1, 64)),      # the stem
               ((8, 64, 512, 512), (3, 3, 64, 2)),     # a logits head
               ((8, 64, 512, 512), (1, 1, 64, 64)),    # a 1x1 kernel
               ((8, 64, 512, 512), (3, 3, 128, 64)),   # Cin mismatch
               ((8, 32, 64, 64), (3, 3, 32, 64)),      # Cin below 64
               ((8, 96, 64, 64), (3, 3, 96, 64)),      # Cin not 64k
               ((8, 64, 64), (3, 3, 64, 64)),          # not 4-d
               ((0, 64, 8, 8), (3, 3, 64, 64))]        # empty batch
    for xs, ks in refused:
        assert not conv.igemm_shapes_supported(xs, ks), (xs, ks)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('n,s,ci,co', [(1, 64, 128, 128), (2, 32, 128, 64)])
def test_plain_matches_library_conv_where_jax_refuses(n, s, ci, co, dtype,
                                                      rng):
    """The 64^2 and 32^2 levels, which the JAX kernel does not take, with
    the plain version held against F.conv2d (float32 at 1e-4; bf16 to
    one bf16 step, both rounding the same bf16 inputs once)."""
    x, k = _inputs(rng, n, s, s, ci, co)
    xt, kt = _nchw(x, dtype), torch.from_numpy(k)
    got = conv.conv3x3_plain(xt, kt)
    want = conv.conv3x3_reference(xt.float(), kt.to(dtype).float())
    if dtype == torch.float32:
        np.testing.assert_allclose(_nhwc(got), _nhwc(want), rtol=1e-4,
                                   atol=1e-4)
    else:
        np.testing.assert_allclose(_nhwc(got), _nhwc(want), rtol=BF16_RTOL,
                                   atol=1e-6)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_wrapper_on_cpu_takes_plain_path(dtype, rng, monkeypatch):
    """CPU tensors go to the plain version and launch nothing, forward
    and backward alike."""
    monkeypatch.setitem(launches, 'conv3x3', 0)
    x, k = _inputs(rng, 1, 6, 10, 64, 128)
    xt = _nchw(x, dtype).requires_grad_(True)
    kt = torch.from_numpy(k).requires_grad_(True)
    got = conv.conv3x3(xt, kt)
    torch.testing.assert_close(got, conv.conv3x3_plain(xt.detach(), kt.detach()),
                               rtol=0, atol=0)
    got.float().sum().backward()
    mul, add = torch.ones(128), torch.zeros(128)
    torch.testing.assert_close(
        conv.conv3x3_bn_relu(xt.detach(), kt.detach(), mul, add),
        conv.conv3x3_plain(xt.detach(), kt.detach(), mul, add, True),
        rtol=0, atol=0)
    assert launches['conv3x3'] == 0


def test_wrapper_refuses_devices_without_a_kernel(rng):
    x, k = _inputs(rng, 1, 4, 4, 64, 64)
    with pytest.raises(ValueError, match='no kernel'):
        conv.conv3x3(_nchw(x).to('meta'), torch.from_numpy(k).to('meta'))


@pytest.mark.parametrize('breakage,error', [
    ('dtype', TypeError), ('cin_mismatch', ValueError),
    ('cout_32', ValueError), ('not_channels_last', ValueError),
    ('mul_dtype', TypeError), ('mul_without_add', ValueError),
    ('mul_shape', ValueError), ('int_kernel', TypeError),
])
def test_kernel_argument_checks(breakage, error, rng):
    """The checks the wrapper makes before a launch refuse what the
    kernel does not take."""
    x, k = _inputs(rng, 1, 4, 8, 64, 64)
    xt, kt = _nchw(x), torch.from_numpy(k)
    mul, add = torch.ones(64), torch.zeros(64)
    if breakage == 'dtype':
        xt = xt.half()
    elif breakage == 'cin_mismatch':
        kt = torch.zeros(3, 3, 128, 64)
    elif breakage == 'cout_32':
        kt = kt[..., :32]
    elif breakage == 'not_channels_last':
        xt = xt.contiguous()
    elif breakage == 'mul_dtype':
        mul = mul.double()
    elif breakage == 'mul_without_add':
        add = None
    elif breakage == 'mul_shape':
        mul, add = torch.ones(32), torch.zeros(32)
    elif breakage == 'int_kernel':
        kt = kt.long()
    with pytest.raises(error):
        conv._check(xt, kt, mul, add)
