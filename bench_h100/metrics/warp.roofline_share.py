"""warp.roofline_share: the augmentation warp kernel's least time (its
bytes over HBM bandwidth, ``yardstick.warp_bound``) times its launches,
over its summed device time in the trace."""

from bench_h100.yardstick import warp_bound


def read(layer, trace):
    if trace is None or layer.get('cell') != 'train':
        return None
    seconds, launches = trace.kernel('warp_kernel')
    if not launches:
        return None
    img = layer['img_size']
    bound = warp_bound(layer['warp_rows'], img, img)[0]
    return 100.0 * bound * launches / seconds
