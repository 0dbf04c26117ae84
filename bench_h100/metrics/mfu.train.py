"""mfu.train: the traced training steps' model operations (forward x 3
for forward and backward, no recompute counted) per second of the traced
window, as a share of one card's bf16 peak."""

from bench_h100.yardstick import PEAK_BF16_FLOPS


def read(layer, trace):
    if trace is None or layer.get('cell') != 'train':
        return None
    flops = layer['slices_traced'] * 3 * layer['flops_per_slice']
    return 100.0 * flops / trace.window_s / PEAK_BF16_FLOPS
