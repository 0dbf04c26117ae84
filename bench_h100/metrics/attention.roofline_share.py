"""attention.roofline_share: the traced steps' attention operations as
the model counts them (``attention_flops_per_slice`` of the reference
module, forward x 3 for forward and backward, no recompute counted)
over the fused attention kernels' device time, as a share of one card's
bf16 peak. Below 100% by construction: the backward recomputes q k^T.
None where no such kernel launched, and None in a cell whose count per
slice is not the TransUNet configuration's at its published widths and
the traced image side: the attention count below holds for that network
alone, and the driver does not hand a cell's model section to a
metric."""

import importlib.util
import json
from pathlib import Path

from bench_h100.yardstick import PEAK_BF16_FLOPS

HERE = Path(__file__).resolve().parent


def _load(name):
    spec = importlib.util.spec_from_file_location(
        'bench_h100_' + name.replace('.', '_').replace('/', '_'),
        HERE.parent / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read(layer, trace):
    if trace is None or layer.get('cell') != 'train':
        return None
    seconds, launches = _load('metrics/attention.device_share') \
        .attention_kernels(trace)
    if not launches:
        return None
    ref = _load('reference/transunet_r50_vit_b16')
    cfg = json.loads((HERE.parent / 'configs/transunet_r50_vit_b16.json')
                     .read_text())
    if (layer.get('flops_per_slice')
            != ref.flops_per_slice(cfg['model'], layer['img_size'])):
        return None
    flops = (3 * ref.attention_flops_per_slice(layer['img_size'])
             * layer['slices_traced'])
    return 100.0 * flops / seconds / PEAK_BF16_FLOPS
