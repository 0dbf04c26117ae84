"""Which shapes the attention gate's bfloat16 (tensor-core) kernel takes,
held on the CPU: the wrapper's checks pass every shape the model's guard
admits, whatever Cg, Cx and I are (the four gates of AttentionUNet-64 and
those of narrower models among them), refuse everything that is not an
exact 2x upsampling before any launch, and the zero padding of Cg, Cx and
I to multiples of 8 that the kernel's TMA loads need changes no value."""

import numpy as np
import pytest
import torch

from unet_tpu_torch.ops import attention_gate as gate

# (Cg, h_in, w_in, Cx, I): the four gates of AttentionUNet-64 at 512^2,
# bilinear (Cg = Cx) and transposed (bilinear: false gates the skip with the
# un-upsampled decoder map, Cg = 2 Cx), and a non-square, non-power-of-two one
MODEL_GATES = [(512, 32, 32, 512, 256), (256, 64, 64, 256, 128),
               (128, 128, 128, 128, 64), (64, 256, 256, 64, 32),
               (1024, 32, 32, 512, 256), (512, 64, 64, 256, 128),
               (256, 128, 128, 128, 64), (128, 256, 256, 64, 32),
               (128, 24, 40, 128, 64)]


def _args(cg, h, w, cx, inter, dtype, h_out=None, w_out=None):
    cl = torch.channels_last
    h_out = 2 * h if h_out is None else h_out
    w_out = 2 * w if w_out is None else w_out
    g = torch.zeros(1, cg, h, w, dtype=dtype).contiguous(memory_format=cl)
    x = torch.zeros(1, cx, h_out, w_out, dtype=dtype).contiguous(
        memory_format=cl)
    return (g, x, torch.zeros(cg, inter, dtype=dtype),
            torch.zeros(cx, inter, dtype=dtype), torch.zeros(inter),
            torch.zeros(inter, 1, dtype=dtype), torch.zeros(1))


@pytest.mark.parametrize('cg,h,w,cx,inter', MODEL_GATES)
def test_model_gates_are_taken(cg, h, w, cx, inter):
    args = _args(cg, h, w, cx, inter, torch.bfloat16)
    assert gate.fused_shapes_supported(args[0].shape, args[1].shape)
    gate._check(*args)


def test_everything_the_guard_admits_is_taken():
    n = 0
    for h in range(8, 41, 8):
        for w in range(8, 41, 8):
            for c in (4, 12, 64):
                args = _args(2 * c, h, w, c, c // 2, torch.bfloat16)
                if gate.fused_shapes_supported(args[0].shape, args[1].shape):
                    gate._check(*args)
                    n += 1
    assert n > 0


@pytest.mark.parametrize('h_out,w_out', [
    (48, 32),   # 3x along H
    (32, 31),   # not 2x along W
    (16, 16),   # no upsampling
    (32, 16),   # 2x along H only
    (64, 64),   # 4x
])
def test_other_shapes_are_refused(h_out, w_out):
    args = _args(64, 16, 16, 64, 32, torch.bfloat16, h_out, w_out)
    assert not gate.fused_shapes_supported(args[0].shape, args[1].shape)
    with pytest.raises(ValueError, match='exactly 2x'):
        gate._check(*args)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_check_takes_unaligned_channels(dtype):
    """A base-4 model's narrowest gate has Cg = Cx = 4 and I = 2: both
    kernels take it (the bfloat16 one on padded operands)."""
    gate._check(*_args(4, 16, 16, 4, 2, dtype))


@pytest.mark.parametrize('cg,cx,inter', [
    (64, 64, 32),       # AttentionUNet-64's narrowest gate
    (8, 8, 4),          # base 8: I is padded to 8 before the launch
    (1024, 1024, 512),  # base 128: I is walked in two chunks of 256
])
def test_check_takes_aligned_gates_in_bf16(cg, cx, inter):
    gate._check(*_args(cg, 16, 16, cx, inter, torch.bfloat16))


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('cg,cx,inter', [
    (16, 8, 4),     # only I is padded
    (16, 8, 36),
    (16, 8, 64),    # nothing is padded
    (4, 4, 2),      # a base-4 model's narrowest gate: all three are padded
    (20, 12, 8),    # only the channels are padded
])
def test_padding_changes_nothing(cg, cx, inter, dtype):
    """The wrapper pads Cg, Cx and I to multiples of 8 for the bf16 kernel:
    the plain version on the padded operands, its padded output channels
    dropped, equals it on the original ones, and what is a multiple of 8
    already is passed through without a copy. Padding I alone gives the
    same bits; padding K = Cg + Cx adds zeros to each sum, which may
    change the order in which this CPU's matmul adds, so that is held to
    the sum's own rounding (float32: 1e-6; bfloat16: one step, 2^-7)."""
    rng = np.random.default_rng(cg + cx + inter)

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))

    def up8(v):
        return -(-v // 8) * 8

    cl = torch.channels_last
    g = rnd(2, cg, 4, 6).to(dtype).contiguous(memory_format=cl)
    x = rnd(2, cx, 8, 12).to(dtype).contiguous(memory_format=cl)
    wg, wx = rnd(cg, inter).to(dtype) / 4, rnd(cx, inter).to(dtype) / 4
    badd, wpsi, bpsi = rnd(inter), rnd(inter, 1).to(dtype), rnd(1)
    given = (g, x, wg, wx, badd, wpsi)
    padded = gate._pad_for_tma(*given)
    assert [tuple(t.shape) for t in padded] == [
        (2, up8(cg), 4, 6), (2, up8(cx), 8, 12), (up8(cg), up8(inter)),
        (up8(cx), up8(inter)), (up8(inter),), (up8(inter), 1)]
    assert all(t.is_contiguous(memory_format=cl) for t in padded[:2])
    assert all(t.is_contiguous() for t in padded[2:])
    for a, b in zip(padded, given):
        if a.shape == b.shape:
            assert a.data_ptr() == b.data_ptr()
    assert not padded[0][:, cg:].any() and not padded[1][:, cx:].any()
    want = gate.attention_gate_reference(*given, bpsi)
    got = gate.attention_gate_reference(*padded, bpsi)
    assert not got[:, cx:].any()
    if (cg % 8, cx % 8) == (0, 0):
        assert torch.equal(got[:, :cx], want)
    else:
        tol = 1e-6 if dtype == torch.float32 else 2.0 ** -7
        torch.testing.assert_close(got[:, :cx], want, rtol=tol, atol=tol)
