"""The yardstick's arithmetic: the H100's published peaks, the least time
of the port's hand-written kernels (operations and bytes from their
shapes) and the model's operations per slice.

Frozen here, apart from the program: ``gate_bound`` and ``warp_bound``
are copies of ``chip_smoke.py``'s, parametrised by the batch; the model
count follows the architecture's equations, not the port's code.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at its 700 W
# limit: bf16 on the tensor cores, and HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def gate_bound(n: int, cg: int, h: int, cx: int, inter: int,
               itemsize: int = 2) -> Tuple[float, int, int]:
    """Least seconds of one fused attention gate over a batch of ``n``:
    g (n, cg, h, h) and x (n, cx, 2h, 2h) read once, the gated x written
    once, the three weight matrices and two float32 biases read once; or
    its operations at the bf16 peak, whichever is larger. Returns
    (seconds, bytes, flops)."""
    pix_out = n * (2 * h) ** 2
    nbytes = ((n * h * h * cg + 2 * pix_out * cx + (cg + cx + 1) * inter)
              * itemsize + 4 * (inter + 1))
    flops = 2 * (cg + cx + 1) * inter * pix_out
    return (max(nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS),
            nbytes, flops)


def warp_bound(n: int, h: int, w: int) -> Tuple[float, int]:
    """Least seconds of one fused augmentation warp over n (h, w) slices:
    rows and cols in (8 B/px), the float32 image in and out (4 B each),
    the uint8 mask in and out (1 B each); its ~20 flops per pixel are
    nothing against the card's rate. Returns (seconds, bytes)."""
    nbytes = n * h * w * (8 + 4 + 4 + 1 + 1)
    return nbytes / HBM_BYTES_PER_S, nbytes


def conv_flops(cin: int, cout: int, k: int, h: int, w: int) -> int:
    """Multiply-adds of a k x k convolution to an (h, w) output, as 2
    flops each."""
    return 2 * cin * cout * k * k * h * w


def _levels(model: Dict) -> Tuple[int, int, bool]:
    return (int(model['base_features']), 2 if model['bilinear'] else 1,
            bool(model['bilinear']))


def gate_shapes(model: Dict, img: int) -> List[Tuple[int, int, int, int]]:
    """The decoder gates of an AttentionUNet at img^2, deepest first, as
    (Cg, h_g, Cx, I): g is (Cg, h_g, h_g), x is (Cx, 2 h_g, 2 h_g). The
    plain UNet has none."""
    if model['type'] != 'attention_unet':
        return []
    f, factor, bilinear = _levels(model)
    out = []
    for level, in_c in enumerate((16 * f, 8 * f, 4 * f, 2 * f)):
        skip = in_c // 2
        gate = skip if bilinear else in_c
        out.append((gate, img // 2 ** (4 - level), skip, skip // 2))
    return out


def model_flops_per_slice(model: Dict, img: int) -> int:
    """Forward operations of one img^2 slice through the UNet or
    AttentionUNet the model section describes: every convolution, the
    gates' 1x1 convolutions at the resolution of their input (W_g at g's,
    W_x and psi at x's) and the 1x1 head. BatchNorm, activations,
    resizes and pools are left out (elementwise, not matrix work)."""
    f, factor, bilinear = _levels(model)
    n_in, n_cls = int(model['n_channels']), int(model['n_classes'])
    total = 0
    enc = [(n_in, f), (f, 2 * f), (2 * f, 4 * f), (4 * f, 8 * f),
           (8 * f, 16 * f // factor)]
    for level, (cin, cout) in enumerate(enc):
        s = img // 2 ** level
        total += conv_flops(cin, cout, 3, s, s) + conv_flops(cout, cout, 3,
                                                             s, s)
    dec = [(16 * f, 8 * f // factor), (8 * f, 4 * f // factor),
           (4 * f, 2 * f // factor), (2 * f, f)]
    for level, (in_c, out_c) in enumerate(dec):
        s = img // 2 ** (3 - level)
        if bilinear:
            mid = in_c // 2
            total += conv_flops(in_c, mid, 3, s, s) + conv_flops(
                mid, out_c, 3, s, s)
        else:
            # 2x2 stride-2 transposed conv from s/2 to s, then DoubleConv
            total += conv_flops(in_c, in_c // 2, 1, s, s)
            total += conv_flops(in_c, out_c, 3, s, s) + conv_flops(
                out_c, out_c, 3, s, s)
    for cg, hg, cx, inter in gate_shapes(model, img):
        total += conv_flops(cg, inter, 1, hg, hg)
        total += conv_flops(cx, inter, 1, 2 * hg, 2 * hg)
        total += conv_flops(inter, 1, 1, 2 * hg, 2 * hg)
    total += conv_flops(f, n_cls, 1, img, img)
    return total
