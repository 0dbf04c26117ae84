"""mfu.device: the traced training steps' model operations (forward x 3
for forward and backward, no recompute counted) per second in which the
card was busy, as a share of one card's bf16 peak: the whole step's
share of the peak on the device's own time, which the host's pace does
not move."""

from bench_h100.yardstick import PEAK_BF16_FLOPS


def read(layer, trace):
    if trace is None or layer.get('cell') != 'train' or not trace.busy_s:
        return None
    flops = layer['slices_traced'] * 3 * layer['flops_per_slice']
    return 100.0 * flops / trace.busy_s / PEAK_BF16_FLOPS
