"""resize.device_share: the bilinear align-corners resize kernels' summed
device time in the traced window (``unet_tpu_torch/csrc/resize.cu``) as a
share of the time the card was busy there. None where they never launched
(a program that resizes through ATen's ``upsample_bilinear2d``)."""

KERNELS = ('resize_forward', 'resize_backward')


def read(layer, trace):
    if trace is None or layer.get('cell') != 'train' or not trace.busy_s:
        return None
    found = [trace.kernel(name) for name in KERNELS]
    if not sum(launches for _, launches in found):
        return None
    return 100.0 * sum(seconds for seconds, _ in found) / trace.busy_s
