"""The yardstick's arithmetic, slices and trace reduction against hand
counts."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_h100 import slices, tracing, yardstick
from bench_h100.common import load_named, load_reference
from bench_h100.reference import model

ATTN = {'type': 'attention_unet', 'n_channels': 1, 'n_classes': 2,
        'bilinear': True, 'base_features': 64, 'deep_supervision': False}
UNET = {**ATTN, 'type': 'unet'}
G = 1e9


def test_gate_bound_by_hand():
    # gate 4 of AttentionUNet-64 at 512^2, batch 8, bf16: g 64x256^2,
    # x 64x512^2, I = 32
    sec, nbytes, flops = yardstick.gate_bound(8, 64, 256, 64, 32)
    px = 8 * 512 * 512
    want_bytes = (8 * 256 * 256 * 64 + 2 * px * 64 + (64 + 64 + 1) * 32) * 2 \
        + 4 * 33
    assert nbytes == want_bytes
    assert flops == 2 * 129 * 32 * px
    assert sec == pytest.approx(want_bytes / 3.35e12)   # bound by bytes
    # the bilinear four at b8: 0.3383 ms (chip_smoke.py's sum)
    total = sum(yardstick.gate_bound(8, *s)[0]
                for s in yardstick.gate_shapes(ATTN, 512))
    assert total * 1e3 == pytest.approx(0.3383, abs=1e-4)


def test_warp_bound_by_hand():
    sec, nbytes = yardstick.warp_bound(32, 512, 512)
    assert nbytes == 32 * 512 * 512 * 18
    assert sec * 1e3 == pytest.approx(0.0451, abs=1e-4)


def test_gate_shapes():
    assert yardstick.gate_shapes(ATTN, 512) == [
        (512, 32, 512, 256), (256, 64, 256, 128), (128, 128, 128, 64),
        (64, 256, 64, 32)]
    assert yardstick.gate_shapes(UNET, 512) == []


def test_model_flops_by_hand():
    conv = lambda ci, co, k, s: 2 * ci * co * k * k * s * s
    enc = (conv(1, 64, 3, 512) + conv(64, 64, 3, 512)
           + conv(64, 128, 3, 256) + conv(128, 128, 3, 256)
           + conv(128, 256, 3, 128) + conv(256, 256, 3, 128)
           + conv(256, 512, 3, 64) + conv(512, 512, 3, 64)
           + conv(512, 512, 3, 32) + conv(512, 512, 3, 32))
    dec = (conv(1024, 512, 3, 64) + conv(512, 256, 3, 64)
           + conv(512, 256, 3, 128) + conv(256, 128, 3, 128)
           + conv(256, 128, 3, 256) + conv(128, 64, 3, 256)
           + conv(128, 64, 3, 512) + conv(64, 64, 3, 512))
    head = conv(64, 2, 1, 512)
    gates = sum(conv(c, i, 1, h) + conv(c, i, 1, 2 * h) + conv(i, 1, 1, 2 * h)
                for c, h, _, i in yardstick.gate_shapes(ATTN, 512))
    assert model.flops_per_slice(UNET, 512) == enc + dec + head
    assert model.flops_per_slice(ATTN, 512) == enc + dec + head + gates
    # the 3x3 convs alone: about 319 GFLOP a slice
    assert (enc + dec) / G == pytest.approx(319.2033, abs=1e-4)


@pytest.mark.parametrize('config, flops', [('attention_unet64', 324670586880),
                                           ('unet64', 319270420480)])
def test_flops_per_slice_of_each_config(config, flops):
    cfg = load_named('configs', config)
    ref = load_reference(cfg)
    assert ref.flops_per_slice(cfg['model'], cfg['img_size']) == flops


def test_ct_slices_seeded():
    a, am = slices.ct_slices(3, 5, 64, 'cpu')
    b, bm = slices.ct_slices(3, 5, 64, 'cpu')
    c, _ = slices.ct_slices(4, 5, 64, 'cpu')
    assert torch.equal(a, b) and torch.equal(am, bm)
    assert not torch.equal(a, c)
    assert a.dtype == torch.uint8 and set(am.unique().tolist()) <= {0, 1}
    assert len({bytes(x.numpy()) for x in a}) == 5


def test_epoch_order_is_the_loaders():
    from unet_tpu_torch.data.dataset import BatchLoader

    class Rows:
        def __len__(self):
            return 24

        def load_raw(self, i):
            return np.full((2, 2), i, np.uint8), np.zeros((2, 2), np.uint8)

    seen = [int(x[0, 0, 0, 0]) for x, _ in BatchLoader(
        Rows(), 1, shuffle=True, drop_last=True, seed=11, num_threads=2,
        raw_uint8=True)]
    assert seen == slices.epoch_order(11, 24).tolist()
    assert slices.train_count(940, 8) == (940 - 188) * 8


def _trace(tmp_path, events):
    path = tmp_path / 't.json'
    path.write_text(json.dumps({'traceEvents': events}))
    return tracing.summarise(path)


def test_trace_busy_gaps_and_kernel_names(tmp_path):
    ev = lambda name, cat, ts, dur: {'ph': 'X', 'name': name, 'cat': cat,
                                     'ts': ts, 'dur': dur}
    s = _trace(tmp_path, [
        ev('bench_window.open', 'user_annotation', 1000, 1),
        ev('bench_window.close', 'user_annotation', 2000, 1),
        ev('void (anonymous namespace)::warp_kernel(float const*, int)',
           'kernel', 1100, 100),
        ev('void (anonymous namespace)::gate_bf16_kernel<128, 4, 1>(X)',
           'kernel', 1150, 100),         # overlaps: busy counts once
        ev('sm90_xmma_warpspecialized_kernel', 'kernel', 1500, 200),
        ev('aten::copy_', 'cpu_op', 1250, 250),
        ev('outside', 'kernel', 2500, 100),
    ])
    assert s.window_s == pytest.approx(1000e-6)
    assert s.busy_s == pytest.approx(350e-6)
    assert s.kernel('warp_kernel') == (pytest.approx(100e-6), 1)
    assert s.kernel('gate_bf16_kernel') == (pytest.approx(100e-6), 1)
    gaps = dict(s.gaps)
    assert gaps['aten::copy_'] == pytest.approx(250e-6)
    assert sum(gaps.values()) == pytest.approx(650e-6)


def test_trace_without_host_ops_takes_the_session_span(tmp_path):
    s = _trace(tmp_path, [
        {'ph': 'X', 'cat': 'Trace', 'name': 'PyTorch Profiler (0)',
         'ts': 0, 'dur': 400},
        {'ph': 'X', 'cat': 'kernel', 'name': 'k', 'ts': 100, 'dur': 100}])
    assert s.window_s == pytest.approx(400e-6)
    assert s.busy_s == pytest.approx(100e-6)


def test_device_readers_divide_by_busy_time(tmp_path):
    """``mfu.device`` and ``batch_norm.device_share`` divide by the time
    the card was busy, the window's own readers by the window; with no
    busy time (the CPU) they read nothing."""
    from bench_h100.run import read_layer_metric
    from bench_h100.yardstick import PEAK_BF16_FLOPS
    root = Path(__file__).resolve().parent
    s = _trace(tmp_path, [
        {'ph': 'X', 'cat': 'Trace', 'name': 'PyTorch Profiler (0)',
         'ts': 0, 'dur': 1000},
        {'ph': 'X', 'cat': 'kernel', 'name': 'void batch_norm_apply<8>(X)',
         'ts': 100, 'dur': 100},
        {'ph': 'X', 'cat': 'kernel', 'name': 'sm90_xmma_fprop',
         'ts': 300, 'dur': 300}])
    layer = {'cell': 'train', 'slices_traced': 2, 'flops_per_slice': 1e9,
             'slices_per_s': 123.5}
    mfu = read_layer_metric(root, 'mfu.device', layer, s)
    assert mfu == pytest.approx(100 * 6e9 / 400e-6 / PEAK_BF16_FLOPS)
    assert read_layer_metric(root, 'mfu.train', layer, s) == pytest.approx(
        mfu * 0.4)
    assert read_layer_metric(root, 'batch_norm.device_share', layer,
                             s) == pytest.approx(25.0)
    assert read_layer_metric(root, 'loop_slices_per_s', layer, s) == 123.5
    idle = dataclasses.replace(s, busy_s=0.0)
    assert read_layer_metric(root, 'mfu.device', layer, idle) is None
    assert read_layer_metric(root, 'batch_norm.device_share', layer,
                             idle) is None
