"""The TransUNet configuration in the harness: on the CPU, a copy of it cut
to a tiny size runs as a cell and is correct, and the float8 control and
the half-batch fault fail where the program passes; the attention
readers read the trace's fused attention kernels; the configuration's
count is the reference's. On the card (``-m chip``) the control and the
half-batch fault fail at the cell's own size and limits."""

import json
import shutil
from pathlib import Path

import pytest
import torch

from bench_h100.test_h100_harness import TINY_LIMITS, run_cell, tiny_copy

HERE = Path(__file__).resolve().parent
CELL = 'transunet-train-b4x8'
SMALL = {'img_size': 64, 'hidden_size': 64, 'num_layers': 2, 'num_heads': 4,
         'mlp_dim': 128, 'resnet_units': [1, 1, 1], 'resnet_width': 32,
         'decoder_channels': [32, 16, 8, 8]}


@pytest.fixture
def small_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_transunet(tmp_path):
    """``tiny_copy`` plus the cell ``tiny-tu``: the TransUNet
    configuration at the small size, on the tiny traffic, reporting what
    the TransUNet cell reports."""
    root = tiny_copy(tmp_path)
    cfg = json.loads((root / 'configs/transunet_r50_vit_b16.json')
                     .read_text())
    cfg['model'].update(SMALL)
    cfg.update(img_size=64, num_workers=2)
    (root / 'configs/tiny_tu.json').write_text(json.dumps(cfg))
    (root / 'workloads/tiny-tu.json').write_text(json.dumps(
        {'config': 'tiny_tu', 'traffic': 'tiny_train', 'chips': 1,
         'limits': TINY_LIMITS}))
    bench = json.loads((tmp_path / 'BENCHMARK.json').read_text())
    for m in bench['end_to_end'] + bench['per_layer']:
        if CELL in m.get('workloads', []):
            m['workloads'].append('tiny-tu')
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(bench))
    return root


def test_the_configuration_runs_as_a_cell(tmp_path, capsys, small_threads):
    root = tiny_transunet(tmp_path)
    rc, res = run_cell(root, capsys, workload='tiny-tu', seed=3141592653)
    assert rc == 0 and res['correct'], res
    assert set(res['metrics']) == {'device_ms_per_slice', 'setup_s'}
    rc, res = run_cell(root, capsys, workload='tiny-tu', seed=7, trace=1)
    assert rc == 0 and res['correct'], res
    # on the CPU no card was busy and no fused attention kernel ran
    assert set(res['metrics']) == {'loop_slices_per_s'}


def test_control_fails_where_the_program_passes(tmp_path, small_threads):
    from bench_h100.common import make_context
    from bench_h100.drivers import train
    root = tiny_transunet(tmp_path)
    ctx = make_context('tiny-tu', 7, 0, device='cpu', root=root)
    try:
        out = train.judge(ctx, train.drive(ctx, window=False), control=True)
    finally:
        shutil.rmtree(ctx.tmp, ignore_errors=True)
    lim = TINY_LIMITS['stats']
    assert out['program']['stats'] <= lim
    assert out['control']['stats'] > lim
    assert out['half_batch']['stats'] > lim


def test_attention_readers(tmp_path):
    from bench_h100 import tracing
    from bench_h100.reference import transunet_r50_vit_b16 as ref
    from bench_h100.run import read_layer_metric
    from bench_h100.yardstick import PEAK_BF16_FLOPS
    fprop = ('cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_'
             'knob_7_64x128x64_4x1x1_cga1x1x1_kernel0_0')
    # another tile and knob of cuDNN's heuristics counts the same
    bprop = ('cudnn_generated_fort_native_sdpa_sm90_flash_bprop_wgmma_f16_'
             'knob_3_128x64x64_1x4x1_cga1x1x1_kernel0_0')
    path = tmp_path / 't.json'
    path.write_text(json.dumps({'traceEvents': [
        {'ph': 'X', 'cat': 'Trace', 'name': 'PyTorch Profiler (0)',
         'ts': 0, 'dur': 1000},
        {'ph': 'X', 'cat': 'kernel', 'name': fprop, 'ts': 100, 'dur': 60},
        {'ph': 'X', 'cat': 'kernel', 'name': bprop, 'ts': 160, 'dur': 40},
        {'ph': 'X', 'cat': 'kernel', 'ts': 250, 'dur': 50,
         'name': 'void cudnn::fusion::convert_dq_to_16bits<true>(X)'},
        {'ph': 'X', 'cat': 'kernel', 'name': 'sm90_xmma_fprop',
         'ts': 300, 'dur': 250}]}))
    s = tracing.summarise(path)
    from bench_h100.common import load_named
    cfg = load_named('configs', 'transunet_r50_vit_b16')
    layer = {'cell': 'train', 'slices_traced': 2, 'img_size': 512,
             'flops_per_slice': ref.flops_per_slice(cfg['model'], 512)}
    share = read_layer_metric(HERE, 'attention.device_share', layer, s)
    assert share == pytest.approx(100 * 150 / 400)
    roof = read_layer_metric(HERE, 'attention.roofline_share', layer, s)
    assert roof == pytest.approx(100 * 3 * ref.attention_flops_per_slice(512)
                                 * 2 / 150e-6 / PEAK_BF16_FLOPS)
    # another network, depth or side: the attention count is not known
    for other in ({**layer, 'flops_per_slice': 1}, {**layer, 'img_size': 256}):
        assert read_layer_metric(HERE, 'attention.roofline_share', other,
                                 s) is None
    none = tracing.summarise(path)
    none.op_seconds = {'sm90_xmma_fprop': 250e-6}
    none.op_counts = {'sm90_xmma_fprop': 1}
    for name in ('attention.device_share', 'attention.roofline_share'):
        assert read_layer_metric(HERE, name, layer, none) is None


def test_the_count_of_the_configuration():
    from bench_h100.common import load_named, load_reference
    cfg = load_named('configs', 'transunet_r50_vit_b16')
    arch = load_reference(cfg)
    assert arch.flops_per_slice(cfg['model'], cfg['img_size']) == 336266231808
    assert arch.attention_flops_per_slice(512) == 38654705664


@pytest.mark.chip
def test_control_fails_at_the_cells_size_on_the_card():
    """The float8 control fails ``stats`` where the program passes, and
    the half-batch fault fails ``change_median``: at this cell it reads
    ``stats`` under the limit on some seeds, the median leaf's change
    never."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    from bench_h100.common import make_context, set_cache_dirs
    from bench_h100.drivers import train
    set_cache_dirs()
    for seed in (1, 2, 3):
        ctx = make_context(CELL, seed, 0)
        try:
            out = train.judge(ctx, train.drive(ctx, window=False),
                              control=True)
        finally:
            shutil.rmtree(ctx.tmp, ignore_errors=True)
        lim = ctx.limits['stats']
        assert out['program']['stats'] <= lim
        assert out['control']['stats'] > lim
        lim = ctx.limits['change_median']
        assert out['program']['change_median'] <= lim
        assert out['half_batch']['change_median'] > lim
