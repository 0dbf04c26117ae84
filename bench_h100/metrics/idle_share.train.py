"""idle_share.train: share of the traced training window in which no
kernel, copy or memset ran on the card."""


def read(layer, trace):
    if trace is None or layer.get('cell') != 'train':
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
