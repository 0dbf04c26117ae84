"""The yardstick's arithmetic: the H100's published peaks, the least time
of the port's hand-written kernels (operations and bytes from their
shapes) and the shapes that a network's count of operations per slice
(its reference module's ``flops_per_slice``) is made of.

Frozen here, apart from the program: ``gate_bound`` and ``warp_bound``
are copies of ``chip_smoke.py``'s, parametrised by the batch; the counts
follow the architecture's equations, not the port's code.
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


def levels(model: Dict) -> Tuple[int, int, bool]:
    """A U-Net's base width, the divisor of its deepest widths (2 with a
    bilinear decoder, 1 with a transposed one) and whether it is
    bilinear."""
    return (int(model['base_features']), 2 if model['bilinear'] else 1,
            bool(model['bilinear']))


def gate_shapes(model: Dict, img: int) -> List[Tuple[int, int, int, int]]:
    """The decoder gates of an AttentionUNet at img^2, deepest first, as
    (Cg, h_g, Cx, I): g is (Cg, h_g, h_g), x is (Cx, 2 h_g, 2 h_g). The
    plain UNet has none."""
    if model['type'] != 'attention_unet':
        return []
    f, factor, bilinear = levels(model)
    out = []
    for level, in_c in enumerate((16 * f, 8 * f, 4 * f, 2 * f)):
        skip = in_c // 2
        gate = skip if bilinear else in_c
        out.append((gate, img // 2 ** (4 - level), skip, skip // 2))
    return out
