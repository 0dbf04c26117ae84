"""loop_slices_per_s: slices of the optimizer steps completed in the
window over the window, as ``train_slices_per_s`` takes them, read in a
traced run (whose traced steps run under the profiler). A per-layer
reading where the host's pace swings the rate too far for a bound."""


def read(layer, trace):
    if layer.get('cell') != 'train':
        return None
    return layer['slices_per_s']
