"""group_norm.device_share: the GroupNorm (+ReLU) kernels' summed device
time in the traced window (``unet_tpu_torch/csrc/group_norm.cu``) as a
share of the time the card was busy there. None where they never
launched (a program without them, or a model without GroupNorm)."""

KERNELS = ('group_norm_stats', 'group_norm_finalize', 'group_norm_apply',
           'group_norm_grad_stats', 'group_norm_grad_finalize',
           'group_norm_grad_input')


def read(layer, trace):
    if trace is None or layer.get('cell') != 'train' or not trace.busy_s:
        return None
    found = [trace.kernel(name) for name in KERNELS]
    if not sum(launches for _, launches in found):
        return None
    return 100.0 * sum(seconds for seconds, _ in found) / trace.busy_s
