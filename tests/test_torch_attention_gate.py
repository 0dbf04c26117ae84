"""The port's attention gate (unet_tpu_torch/ops/attention_gate.py)
against the JAX package's Pallas kernel (interpret mode) and its
reference, on the same numpy inputs. The CUDA kernel itself runs only on
a GPU; chip_smoke.py holds it against the plain version there."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_tpu.ops.pallas import attention_gate as jgate
from unet_tpu_torch.ops import attention_gate as gate

torch.set_num_threads(2)

# the shapes of tests/test_pallas.py (NHWC)
CASES = [
    ((2, 16, 16, 32), (2, 32, 32, 16)),
    ((1, 16, 16, 64), (1, 32, 32, 64)),
    ((2, 32, 32, 128), (2, 64, 64, 64)),
]


def _case(rng, gs, xs):
    cg, cx = gs[-1], xs[-1]
    inter = cx // 2
    mk = lambda *s: rng.standard_normal(s, dtype=np.float32)
    return (mk(*gs), mk(*xs), mk(cg, inter) * 0.1, mk(cx, inter) * 0.1,
            mk(inter) * 0.1, mk(inter, 1) * 0.1, 0.05)


def _torch_args(args, dtype=torch.float32):
    g, x, wg, wx, badd, wpsi, bpsi = args
    cl = torch.channels_last
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2).to(
        dtype=dtype, memory_format=cl)
    t = lambda a: torch.from_numpy(a).to(dtype)
    return (nchw(g), nchw(x), t(wg), t(wx), torch.from_numpy(badd),
            t(wpsi), bpsi)


@pytest.mark.parametrize('gs,xs', CASES)
def test_plain_gate_matches_pallas_interpret_and_reference(gs, xs, rng):
    args = _case(rng, gs, xs)
    jargs = [jnp.asarray(a) for a in args[:-1]] + [args[-1]]
    want_kernel = np.asarray(jgate.attention_gate_fused(*jargs,
                                                        interpret=True))
    want_ref = np.asarray(jgate.attention_gate_reference(*jargs))
    got = gate.attention_gate_reference(*_torch_args(args))
    got = got.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want_kernel, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, want_ref, rtol=1e-4, atol=1e-5)


def test_fold_bn_into_conv_matches_jax(rng):
    cin, cout = 8, 4
    k = rng.standard_normal((cin, cout), dtype=np.float32)
    scale = rng.random(cout, dtype=np.float32) + 0.5
    bias = rng.standard_normal(cout, dtype=np.float32)
    mean = rng.standard_normal(cout, dtype=np.float32)
    var = rng.random(cout, dtype=np.float32) + 0.1
    arrays = (k, scale, bias, mean, var)
    wk, wb = jgate.fold_bn_into_conv(*map(jnp.asarray, arrays), eps=1e-5)
    gk, gb = gate.fold_bn_into_conv(*map(torch.from_numpy, arrays), eps=1e-5)
    # rsqrt may differ by an ulp between XLA and ATen
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), rtol=1e-6)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=1e-6,
                               atol=1e-6)


def test_fused_shapes_supported_matches_jax():
    """Same decision as the JAX guard on a grid of shapes (the port
    takes NCHW shapes, JAX NHWC)."""
    sizes = (4, 8, 12, 15, 16, 24, 32, 33)
    n = 0
    for h_in, w_in, rh, rw, dh in itertools.product(
            sizes, sizes, (1, 2, 3), (1, 2), (0, 1)):
        h_out, w_out = rh * h_in + dh, rw * w_in
        want = jgate.fused_shapes_supported((2, h_in, w_in, 8),
                                            (2, h_out, w_out, 4))
        got = gate.fused_shapes_supported((2, 8, h_in, w_in),
                                          (2, 4, h_out, w_out))
        assert got == want, (h_in, w_in, h_out, w_out)
        n += want
    assert n > 0  # the grid reaches both answers


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_wrapper_on_cpu_takes_plain_path(dtype, rng, monkeypatch):
    """CPU tensors go to the plain version and launch nothing."""
    monkeypatch.setattr(gate, 'launch_count', 0)
    args = _torch_args(_case(rng, *CASES[0]), dtype)
    got = gate.attention_gate_fused(*args)
    want = gate.attention_gate_reference(*args)
    assert got.dtype == dtype and got.shape == args[1].shape
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert gate.launch_count == 0


def test_wrapper_refuses_devices_without_a_kernel(rng):
    args = _torch_args(_case(rng, *CASES[0]))
    meta = [a.to('meta') if torch.is_tensor(a) else a for a in args]
    with pytest.raises(ValueError, match='no kernel'):
        gate.attention_gate_fused(*meta)


@pytest.mark.parametrize('breakage,error', [
    ('dtype', TypeError), ('wg_shape', ValueError),
    ('not_channels_last', ValueError), ('badd_dtype', TypeError),
    ('band_outside_map', ValueError), ('band_lacks_g_rows', ValueError),
])
def test_kernel_argument_checks(breakage, error, rng):
    """The checks the wrapper makes before a launch refuse what the
    kernel does not take."""
    g, x, wg, wx, badd, wpsi, _ = _torch_args(_case(rng, *CASES[0]))
    bpsi = torch.tensor([0.05])
    band = None
    if breakage == 'band_outside_map':  # rows 24..56 of a 32-row map
        band = gate.GateBand(24, 0, 16, 32)
    elif breakage == 'band_lacks_g_rows':  # rows 0..8 of 32 read g 0..4
        x = x[:, :, :8].contiguous(memory_format=torch.channels_last)
        g = g[:, :, 1:8].contiguous(memory_format=torch.channels_last)
        band = gate.GateBand(0, 1, 16, 32)
    if breakage == 'dtype':
        g, x = g.half(), x.half()
    elif breakage == 'wg_shape':
        wg = wg[:, :-1]
    elif breakage == 'not_channels_last':
        x = x.contiguous()
    elif breakage == 'badd_dtype':
        badd = badd.double()
    with pytest.raises(error):
        gate._check(g, x, wg, wx, badd, wpsi, bpsi, band)


@pytest.mark.parametrize('start,stop', [(0, 32), (32, 64), (5, 27),
                                        (63, 64), (0, 64)])
def test_band_gate_equals_rows_of_the_whole_map(start, stop, rng):
    """A band's gate (x rows [start, stop), g the rows they read, on
    the global coordinates) equals those rows of the whole map's gate,
    and of the Pallas kernel's (interpret mode)."""
    from unet_tpu_torch.ops.resize import source_rows
    args = _case(rng, *CASES[2])  # g 32^2 -> x 64^2
    jargs = [jnp.asarray(a) for a in args[:-1]] + [args[-1]]
    want_kernel = np.asarray(jgate.attention_gate_fused(*jargs,
                                                        interpret=True))
    g, x, *rest = _torch_args(args)
    whole = gate.attention_gate_fused(g, x, *rest)
    lo, hi = source_rows(32, 64, start, stop)
    got = gate.attention_gate_fused(
        g[:, :, lo:hi], x[:, :, start:stop], *rest,
        gate.GateBand(start, lo, 32, 64))
    assert got.shape == x[:, :, start:stop].shape
    # the band lerps rows then columns in float32, ATen's resize blends
    # the four taps in another order: float32 rounding apart
    np.testing.assert_allclose(got.numpy(), whole[:, :, start:stop].numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               want_kernel[:, start:stop], rtol=1e-4,
                               atol=1e-5)


def test_align_scale_is_f32_rounded():
    assert gate._align_scale(32, 64) == float(np.float32(31 / 63))
    assert gate._align_scale(1, 8) == 0.0
    assert gate._align_scale(5, 1) == 0.0
