"""Batched on-device data augmentation.

Counterpart of ``unet_tpu/data/augmentations.py``: the train-time
pipeline of the reference albumentations transforms, run on the whole
super-batch on the device:

  HorizontalFlip / VerticalFlip / Affine  -> one inverse affine map
  ElasticTransform                        -> smoothed displacement field
  GridDistortion                          -> per-axis piecewise-linear map
  RandomBrightnessContrast, GaussNoise,
  CoarseDropout, Normalize                -> elementwise, image only

The geometric transforms compose into ONE sampling grid, so each image
and mask is resampled once: for C == 1 by the fused warp kernel
(``ops/warp.py::grid_sample_fused``), for C > 1 by the plain bilinear
and nearest samplers.

``jax.random`` streams cannot be reproduced in torch, so the pipeline is
split in two: ``draw_augment_params`` takes every random draw from a
``torch.Generator`` (the raw draws, including the unsmoothed U(-1, 1)
elastic fields and the normal noise field), and ``apply_augment`` is a
deterministic function of those draws. Tests feed ``apply_augment`` the
JAX package's own draws.

Shapes: images (N, C, H, W) float32 in [0, 1]; masks (N, H, W) uint8.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from unet_tpu_torch.ops.warp import (grid_sample_bilinear,
                                     grid_sample_fused, grid_sample_nearest)


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Augmentation hyperparameters (defaults: the reference
    albumentations pipeline)."""
    p_hflip: float = 0.5
    p_vflip: float = 0.3
    p_affine: float = 0.5
    translate_pct: float = 0.1
    scale_min: float = 0.85
    scale_max: float = 1.15
    rotate_deg: float = 15.0
    p_elastic: float = 0.3
    elastic_alpha: float = 50.0
    elastic_sigma: float = 10.0
    p_grid: float = 0.3
    grid_steps: int = 5
    grid_limit: float = 0.2
    p_brightness: float = 0.3
    brightness_limit: float = 0.15
    contrast_limit: float = 0.15
    p_noise: float = 0.2
    noise_std_min: float = 0.01
    noise_std_max: float = 0.02
    p_dropout: float = 0.1
    dropout_holes_max: int = 4
    hole_frac_min: float = 0.03
    hole_frac_max: float = 0.06
    mean: float = 0.5
    std: float = 0.5

    @classmethod
    def from_yaml(cls, aug_cfg: Optional[dict]) -> 'AugmentConfig':
        """Map the YAML ``augmentation`` section onto this config (the
        reference keys, plus the extension keys that expose the
        probabilities the reference hardcodes)."""
        aug_cfg = aug_cfg or {}
        return cls(
            p_hflip=aug_cfg.get('horizontal_flip', 0.5),
            rotate_deg=float(aug_cfg.get('rotation_limit', 15)),
            p_elastic=aug_cfg.get('elastic', 0.3),
            p_brightness=aug_cfg.get('brightness_contrast', 0.3),
            p_vflip=aug_cfg.get('vertical_flip', 0.3),
            p_affine=aug_cfg.get('affine', 0.5),
            p_grid=aug_cfg.get('grid_distortion', 0.3),
            p_noise=aug_cfg.get('gauss_noise', 0.2),
            p_dropout=aug_cfg.get('coarse_dropout', 0.1),
        )


@dataclasses.dataclass
class AugmentParams:
    """Every random draw of one ``apply_augment`` call, raw (before any
    scaling by its probability gate). Gates are float32 {0, 1}; the rest
    float32 unless noted. N samples, K = ``dropout_holes_max``."""
    affine_on: torch.Tensor       # (N,)
    angle_deg: torch.Tensor       # (N,) U(-rotate_deg, rotate_deg)
    scale: torch.Tensor           # (N,) U(scale_min, scale_max)
    translate: torch.Tensor       # (N, 2) U(-translate_pct, translate_pct)
    hflip: torch.Tensor           # (N,)
    vflip: torch.Tensor           # (N,)
    elastic_on: torch.Tensor      # (N,)
    elastic_dy: torch.Tensor      # (N, H, W) U(-1, 1), unsmoothed
    elastic_dx: torch.Tensor      # (N, H, W) U(-1, 1), unsmoothed
    grid_r_on: torch.Tensor       # (N,)
    grid_r: torch.Tensor          # (N, grid_steps) U(-grid_limit, grid_limit)
    grid_c_on: torch.Tensor       # (N,)
    grid_c: torch.Tensor          # (N, grid_steps)
    bc_on: torch.Tensor           # (N,)
    contrast: torch.Tensor        # (N,) U(-contrast_limit, contrast_limit)
    brightness: torch.Tensor      # (N,) U(-brightness_limit, brightness_limit)
    noise_on: torch.Tensor        # (N,)
    noise_std: torch.Tensor       # (N,) U(noise_std_min, noise_std_max)
    noise: torch.Tensor           # (N, C, H, W) standard normal
    drop_on: torch.Tensor         # (N,)
    holes: torch.Tensor           # (N,) int64 in [1, K]
    hole_h: torch.Tensor          # (N, K) U(hole_frac_min, hole_frac_max)
    hole_w: torch.Tensor          # (N, K) U(hole_frac_min, hole_frac_max)
    hole_top: torch.Tensor        # (N, K) U(0, 1)
    hole_left: torch.Tensor       # (N, K) U(0, 1)

    def take(self, rows: torch.Tensor) -> 'AugmentParams':
        """The draws of the given samples (a 1-D index tensor)."""
        return AugmentParams(**{f.name: getattr(self, f.name)[rows]
                                for f in dataclasses.fields(self)})


def generator_for_step(seed: int, step: int,
                       device: torch.device) -> torch.Generator:
    """The generator of augmentation step ``step`` of a run seeded with
    ``seed``: both words are mixed by numpy's SeedSequence, so every
    (seed, step) pair gets its own stream."""
    words = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(words[0]) << 32 | int(words[1]))
    return gen


def draw_augment_params(n: int, h: int, w: int, cfg: AugmentConfig,
                        generator: torch.Generator,
                        device: torch.device, channels: int = 1
                        ) -> AugmentParams:
    """Take every random draw of the pipeline from ``generator`` (which
    lives on ``device``)."""
    kw = dict(generator=generator, device=device)

    def u(lo, hi, *shape):
        return torch.rand(*shape, **kw) * (hi - lo) + lo

    def gate(p):
        return (torch.rand(n, **kw) < p).float()

    k = cfg.dropout_holes_max
    steps = cfg.grid_steps
    return AugmentParams(
        affine_on=gate(cfg.p_affine),
        angle_deg=u(-cfg.rotate_deg, cfg.rotate_deg, n),
        scale=u(cfg.scale_min, cfg.scale_max, n),
        translate=u(-cfg.translate_pct, cfg.translate_pct, n, 2),
        hflip=gate(cfg.p_hflip),
        vflip=gate(cfg.p_vflip),
        elastic_on=gate(cfg.p_elastic),
        elastic_dy=u(-1.0, 1.0, n, h, w),
        elastic_dx=u(-1.0, 1.0, n, h, w),
        grid_r_on=gate(cfg.p_grid),
        grid_r=u(-cfg.grid_limit, cfg.grid_limit, n, steps),
        grid_c_on=gate(cfg.p_grid),
        grid_c=u(-cfg.grid_limit, cfg.grid_limit, n, steps),
        bc_on=gate(cfg.p_brightness),
        contrast=u(-cfg.contrast_limit, cfg.contrast_limit, n),
        brightness=u(-cfg.brightness_limit, cfg.brightness_limit, n),
        noise_on=gate(cfg.p_noise),
        noise_std=u(cfg.noise_std_min, cfg.noise_std_max, n),
        noise=torch.randn(n, channels, h, w, **kw),
        drop_on=gate(cfg.p_dropout),
        holes=torch.randint(1, k + 1, (n,), **kw),
        hole_h=u(cfg.hole_frac_min, cfg.hole_frac_max, n, k),
        hole_w=u(cfg.hole_frac_min, cfg.hole_frac_max, n, k),
        hole_top=u(0.0, 1.0, n, k),
        hole_left=u(0.0, 1.0, n, k),
    )


# ---------------------------------------------------------------- geometry

def affine_maps(p: AugmentParams, h: int, w: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample inverse affine maps (``_affine_matrices``): lin
    (N, 2, 2) acting on centred (row, col) output coordinates, and the
    translation t (N, 2) in pixels. Flips are folded in as -1 axis
    scales."""
    apply = p.affine_on
    angle = torch.deg2rad(p.angle_deg) * apply
    scale = 1.0 + (p.scale - 1.0) * apply
    t = p.translate * apply[:, None] * torch.tensor(
        [h, w], dtype=torch.float32, device=apply.device)
    cos, sin = torch.cos(angle), torch.sin(angle)
    inv_s = 1.0 / scale
    sign_r = 1.0 - 2.0 * p.vflip
    sign_c = 1.0 - 2.0 * p.hflip
    a00 = inv_s * cos * sign_r
    a01 = inv_s * sin * sign_c
    a10 = -inv_s * sin * sign_r
    a11 = inv_s * cos * sign_c
    lin = torch.stack([torch.stack([a00, a01], -1),
                       torch.stack([a10, a11], -1)], -2)
    return lin, t


def gaussian_kernel1d(sigma: float, radius: int,
                      device: torch.device) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def smooth2d(field: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of (N, H, W) fields, radius
    ``max(1, int(3 sigma))``, zero padded (``_smooth2d``). Runs in true
    float32: TF32 would move the coordinates that pick mask pixels, so
    cuDNN's TF32 is switched off around the two convolutions."""
    radius = max(1, int(3.0 * sigma))
    k = gaussian_kernel1d(sigma, radius, field.device)
    f = field[:, None]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        f = F.conv2d(f, k.view(1, 1, -1, 1), padding=(radius, 0))
        f = F.conv2d(f, k.view(1, 1, 1, -1), padding=(0, radius))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return f[:, 0]


def elastic_displacement(p: AugmentParams, cfg: AugmentConfig
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ElasticTransform fields alpha * blur(U(-1, 1), sigma), gated
    (``_elastic_displacement``)."""
    apply = p.elastic_on[:, None, None]
    dy = smooth2d(p.elastic_dy, cfg.elastic_sigma)
    dx = smooth2d(p.elastic_dx, cfg.elastic_sigma)
    return dy * cfg.elastic_alpha * apply, dx * cfg.elastic_alpha * apply


def grid_distortion_map(apply: torch.Tensor, factors_raw: torch.Tensor,
                        size: int, steps: int) -> torch.Tensor:
    """Per-axis GridDistortion map (``_grid_distortion_map``): the axis
    in ``steps`` cells, each cell's width scaled by (1 + U), evaluated
    densely. Not renormalized: a distorted map may run past the border
    and sample the zero border. Returns (N, size) source coordinates."""
    n = apply.shape[0]
    dev = apply.device
    a = apply[:, None]
    factors = 1.0 + factors_raw
    factors = a * factors + (1.0 - a)
    cell = size / steps
    widths = factors * cell
    edges = torch.cat([torch.zeros(n, 1, device=dev),
                       torch.cumsum(widths, -1)], -1)
    x = torch.arange(size, dtype=torch.float32, device=dev)
    c = torch.clamp(torch.div(x, cell, rounding_mode='floor').to(torch.int64),
                    0, steps - 1)
    frac = (x - c.to(torch.float32) * cell) / cell
    e0 = torch.gather(edges, 1, c.expand(n, size))
    e1 = torch.gather(edges, 1, (c + 1).expand(n, size))
    return e0 + frac[None, :] * (e1 - e0)


def sampling_grid(p: AugmentParams, cfg: AugmentConfig, h: int, w: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compose grid distortion, elastic and affine into one (rows, cols)
    source-coordinate grid, (N, H, W) each (``augment_batch``'s
    composition)."""
    n = p.affine_on.shape[0]
    lin, trans = affine_maps(p, h, w)
    dy, dx = elastic_displacement(p, cfg)
    src_r = grid_distortion_map(p.grid_r_on, p.grid_r, h, cfg.grid_steps)
    src_c = grid_distortion_map(p.grid_c_on, p.grid_c, w, cfg.grid_steps)
    base_r = src_r[:, :, None].expand(n, h, w) + dy
    base_c = src_c[:, None, :].expand(n, h, w) + dx
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    pr = base_r - trans[:, 0, None, None] - cy
    pc = base_c - trans[:, 1, None, None] - cx
    rows = lin[:, 0, 0, None, None] * pr + lin[:, 0, 1, None, None] * pc + cy
    cols = lin[:, 1, 0, None, None] * pr + lin[:, 1, 1, None, None] * pc + cx
    return rows, cols


# ---------------------------------------------------------------- photometric

def brightness_contrast(images: torch.Tensor, p: AugmentParams
                        ) -> torch.Tensor:
    apply = p.bc_on[:, None, None, None]
    alpha = 1.0 + p.contrast[:, None, None, None] * apply
    beta = p.brightness[:, None, None, None] * apply
    return torch.clamp(images * alpha + beta, 0.0, 1.0)


def gauss_noise(images: torch.Tensor, p: AugmentParams) -> torch.Tensor:
    apply = p.noise_on[:, None, None, None]
    noise = p.noise * p.noise_std[:, None, None, None] * apply
    return torch.clamp(images + noise, 0.0, 1.0)


def coarse_dropout(images: torch.Tensor, p: AugmentParams) -> torch.Tensor:
    """1..K zero-filled rectangles per image, each hole's height and
    width drawn independently (``_coarse_dropout``); image only."""
    n, _, h, w = images.shape
    k = p.hole_h.shape[1]
    dev = images.device
    hole_h = p.hole_h * h
    hole_w = p.hole_w * w
    top = p.hole_top * (h - hole_h)
    left = p.hole_left * (w - hole_w)
    rows = torch.arange(h, dtype=torch.float32, device=dev)[None, None, :]
    cols = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    in_r = (rows >= top[..., None]) & (rows < (top + hole_h)[..., None])
    in_c = (cols >= left[..., None]) & (cols < (left + hole_w)[..., None])
    on = (torch.arange(k, device=dev)[None, :] < p.holes[:, None])
    on = on & (p.drop_on[:, None] > 0)
    covered = torch.einsum('nkh,nkw->nhw', (in_r & on[..., None]).float(),
                           in_c.float()) > 0
    return images * (~covered)[:, None].to(images.dtype)


def normalize_batch(images: torch.Tensor, mean: float = 0.5,
                    std: float = 0.5) -> torch.Tensor:
    """Val/test transform: Normalize(mean, std) only."""
    return (images - mean) / std


def apply_augment(images: torch.Tensor, masks: torch.Tensor,
                  p: AugmentParams, cfg: AugmentConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The full train-time augmentation given its draws. images
    (N, C, H, W) float32 in [0, 1], masks (N, H, W) uint8 ->
    (normalized images, masks)."""
    _, ch, h, w = images.shape
    rows, cols = sampling_grid(p, cfg, h, w)
    if ch == 1:
        images, masks = grid_sample_fused(images, masks, rows, cols)
    else:
        images = grid_sample_bilinear(images, rows, cols)
        masks = grid_sample_nearest(masks, rows, cols)
    images = brightness_contrast(images, p)
    images = gauss_noise(images, p)
    images = coarse_dropout(images, p)
    return normalize_batch(images, cfg.mean, cfg.std), masks


def local_rows(groups: int, local_batch: int, index: int, count: int,
               device=None) -> torch.Tensor:
    """Rows of rank ``index`` of ``count`` in a global batch laid out as
    ``groups`` microbatches of ``local_batch * count`` rows, where each
    rank holds its contiguous ``local_batch`` rows of every microbatch."""
    per_group = local_batch * count
    offsets = torch.arange(groups, device=device)[:, None] * per_group
    return (offsets + index * local_batch
            + torch.arange(local_batch, device=device)[None, :]).reshape(-1)


def augment_batch_seeded(images: torch.Tensor, masks: torch.Tensor,
                         seed: int, step: int, cfg: AugmentConfig,
                         local_slice: Optional[Tuple[int, int]] = None,
                         groups: int = 1
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw on the images' device from the (seed, step) generator, then
    apply: the train loop's call, with seed = config seed + 1.

    With ``local_slice=(index, count)`` the images are one rank's rows
    of a global batch of ``groups`` microbatches (``local_rows``): the
    draws are the global batch's, and the rank applies its rows' share,
    so every row gets the augmentation a single process would give it."""
    n, ch, h, w = images.shape
    gen = generator_for_step(seed, step, images.device)
    if local_slice is None:
        params = draw_augment_params(n, h, w, cfg, gen, images.device, ch)
    else:
        index, count = local_slice
        params = draw_augment_params(n * count, h, w, cfg, gen,
                                     images.device, ch).take(
            local_rows(groups, n // groups, index, count, images.device))
    return apply_augment(images, masks, params, cfg)


__all__ = ['AugmentConfig', 'AugmentParams', 'apply_augment',
           'augment_batch_seeded', 'draw_augment_params',
           'generator_for_step', 'local_rows', 'normalize_batch']
