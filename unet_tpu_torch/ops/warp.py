"""Fused augmentation resample: CUDA kernel wrapper and plain versions.

Counterpart of ``unet_tpu/ops/pallas/warp.py::grid_sample_fused_pallas``
and of ``_grid_sample_fused``, ``_grid_sample_bilinear`` and
``_grid_sample_nearest`` in ``unet_tpu/data/augmentations.py``. Given
per-pixel source coordinates (rows, cols), one pass samples

  * the image bilinearly, the whole pixel zeroed where its coordinate
    leaves [0, H-1] x [0, W-1] (not ``F.grid_sample``'s per-tap zero
    padding, which blends an out-of-range tap as a zero), with the
    corner clamped to ``r0 = min(floor(r), H-2)``, ``c0 = min(floor(c),
    W-2)``, so on the last row ``wr`` is 1.0;
  * the mask by nearest neighbour, picking the upper tap when the
    fraction is > 0.5, or == 0.5 with an odd floor (round half to even),
    0 outside.

``grid_sample_fused`` launches the hand-written kernel
(``unet_tpu_torch/csrc/warp.cu``) on CUDA tensors and takes the plain
PyTorch version, ``grid_sample_fused_reference``, only for tensors on
the CPU. Masks travel as uint8 (labels are {0, 1}): 1 byte per pixel in
and out instead of the 4 of an int32 mask.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

# Kernel launches since the count was last reset (chip_smoke.py resets
# it before driving the main path and reads it after).
launch_count = 0


def _corners(rows: torch.Tensor, cols: torch.Tensor, h: int, w: int):
    """valid, clamped upper-left corner (r0, c0) and fractions (wr, wc),
    as ``_grid_sample_fused`` forms them; ``valid`` tests the unclamped
    coordinates."""
    valid = (rows >= 0) & (rows <= h - 1) & (cols >= 0) & (cols <= w - 1)
    r = torch.clamp(rows, 0.0, h - 1.0)
    c = torch.clamp(cols, 0.0, w - 1.0)
    r0 = torch.clamp(torch.floor(r), max=h - 2).to(torch.int64)
    c0 = torch.clamp(torch.floor(c), max=w - 2).to(torch.int64)
    wr = r - r0.to(r.dtype)
    wc = c - c0.to(c.dtype)
    return valid, r0, c0, wr, wc


def _round_up(frac: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Round half to even on (floor, fraction): take lo + 1 iff
    frac > 1/2, or frac == 1/2 with an odd floor."""
    return (frac > 0.5) | ((frac == 0.5) & (lo % 2 == 1))


def _gather(plane: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """plane (N, H*W), idx (N, H, W) flat indices -> (N, H, W)."""
    return torch.gather(plane, 1, idx.reshape(idx.shape[0], -1)).reshape(
        idx.shape)


def grid_sample_fused_reference(images: torch.Tensor, masks: torch.Tensor,
                                rows: torch.Tensor, cols: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fused warp, operation for operation
    as ``_grid_sample_fused``; each step is its own ATen op, so nothing
    is contracted into an FMA. images (N, 1, H, W) float32, masks
    (N, H, W) of any integer type, rows/cols (N, H, W) float32 ->
    (images (N, 1, H, W), masks (N, H, W) in the masks' dtype)."""
    n, _, h, w = images.shape
    valid, r0, c0, wr, wc = _corners(rows, cols, h, w)
    img = images.reshape(n, h * w)
    i00 = r0 * w + c0
    t00, t01 = _gather(img, i00), _gather(img, i00 + 1)
    t10, t11 = _gather(img, i00 + w), _gather(img, i00 + w + 1)
    omr, omc = 1 - wr, 1 - wc
    out = (t00 * omr * omc + t01 * omr * wc + t10 * wr * omc
           + t11 * wr * wc)
    out = out * valid.to(out.dtype)
    rn = r0 + _round_up(wr, r0).to(torch.int64)
    cn = c0 + _round_up(wc, c0).to(torch.int64)
    m = _gather(masks.reshape(n, h * w), rn * w + cn)
    m = torch.where(valid, m, torch.zeros_like(m))
    return out[:, None], m


def grid_sample_bilinear(images: torch.Tensor, rows: torch.Tensor,
                         cols: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling with a zero border for C > 1 images (N, C, H, W)
    (``_grid_sample_bilinear``: the upper corner is ``min(r0 + 1, H-1)``,
    not the fused form's clamp of r0)."""
    n, ch, h, w = images.shape
    valid = (rows >= 0) & (rows <= h - 1) & (cols >= 0) & (cols <= w - 1)
    r = torch.clamp(rows, 0.0, h - 1.0)
    c = torch.clamp(cols, 0.0, w - 1.0)
    r0 = torch.floor(r).to(torch.int64)
    c0 = torch.floor(c).to(torch.int64)
    r1 = torch.clamp(r0 + 1, max=h - 1)
    c1 = torch.clamp(c0 + 1, max=w - 1)
    wr = (r - r0.to(r.dtype))[:, None]
    wc = (c - c0.to(c.dtype))[:, None]
    flat = images.reshape(n, ch, h * w)

    def gat(ri, ci):
        idx = (ri * w + ci).reshape(n, 1, h * w).expand(n, ch, h * w)
        return torch.gather(flat, 2, idx).reshape(n, ch, h, w)

    out = (gat(r0, c0) * (1 - wr) * (1 - wc) + gat(r0, c1) * (1 - wr) * wc
           + gat(r1, c0) * wr * (1 - wc) + gat(r1, c1) * wr * wc)
    return out * valid[:, None].to(out.dtype)


def grid_sample_nearest(masks: torch.Tensor, rows: torch.Tensor,
                        cols: torch.Tensor) -> torch.Tensor:
    """Nearest sampling (round half to even) with a zero border for
    integer masks (N, H, W) (``_grid_sample_nearest``)."""
    n, h, w = masks.shape
    valid = (rows >= 0) & (rows <= h - 1) & (cols >= 0) & (cols <= w - 1)
    ri = torch.clamp(torch.round(rows), 0, h - 1).to(torch.int64)
    ci = torch.clamp(torch.round(cols), 0, w - 1).to(torch.int64)
    out = _gather(masks.reshape(n, h * w), ri * w + ci)
    return torch.where(valid, out, torch.zeros_like(out))


def _lib() -> ctypes.CDLL:
    from unet_tpu_torch.ops import _build
    lib = _build.load('warp')
    if lib.warp_launch.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.warp_launch.argtypes = [ptr] * 6 + [i32] * 3 + [ptr]
        lib.warp_launch.restype = ctypes.c_int
        lib.warp_error_string.argtypes = [i32]
        lib.warp_error_string.restype = ctypes.c_char_p
    return lib


def _check(images, masks, rows, cols) -> None:
    if images.dim() != 4 or images.shape[1] != 1:
        raise ValueError(f'warp: images {tuple(images.shape)} must be '
                         '(N, 1, H, W); C > 1 takes grid_sample_bilinear')
    n, _, h, w = images.shape
    if h < 2 or w < 2:
        raise ValueError(f'warp: needs H, W >= 2, got {h}x{w}')
    if h * w >= 2 ** 31:
        raise ValueError(f'warp: a {h}x{w} plane is too large')
    want = {'images': (images, torch.float32, (n, 1, h, w)),
            'masks': (masks, torch.uint8, (n, h, w)),
            'rows': (rows, torch.float32, (n, h, w)),
            'cols': (cols, torch.float32, (n, h, w))}
    for name, (t, dtype, shape) in want.items():
        if t.device != images.device:
            raise ValueError(f'warp: {name} on {t.device}, images on '
                             f'{images.device}')
        if t.dtype != dtype:
            raise TypeError(f'warp: {name} is {t.dtype}, needs {dtype}')
        if tuple(t.shape) != shape:
            raise ValueError(f'warp: {name} has shape {tuple(t.shape)}, '
                             f'needs {shape}')


def grid_sample_fused(images: torch.Tensor, masks: torch.Tensor,
                      rows: torch.Tensor, cols: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused bilinear(image) + nearest(mask) warp.

    Args:
      images: (N, 1, H, W) float32
      masks: (N, H, W) uint8
      rows, cols: (N, H, W) float32 source coordinates
    Returns (images (N, 1, H, W) float32, masks (N, H, W) uint8).

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes
    ``grid_sample_fused_reference``. Any H, W >= 2.
    """
    global launch_count
    _check(images, masks, rows, cols)
    if images.device.type == 'cpu':
        return grid_sample_fused_reference(images, masks, rows, cols)
    if images.device.type != 'cuda':
        raise ValueError(f'warp: no kernel for {images.device}')
    if images.device.index != torch.cuda.current_device():
        raise ValueError(f'warp: images are on {images.device}, the current '
                         f'device is {torch.cuda.current_device()}')
    images, masks = images.contiguous(), masks.contiguous()
    rows, cols = rows.contiguous(), cols.contiguous()
    n, _, h, w = images.shape
    out_img = torch.empty_like(images)
    out_msk = torch.empty_like(masks)
    lib = _lib()
    err = lib.warp_launch(
        images.data_ptr(), masks.data_ptr(), rows.data_ptr(),
        cols.data_ptr(), out_img.data_ptr(), out_msk.data_ptr(), n, h, w,
        torch.cuda.current_stream(images.device).cuda_stream)
    if err:
        raise RuntimeError('warp kernel launch failed: '
                           + lib.warp_error_string(err).decode())
    launch_count += 1
    return out_img, out_msk
