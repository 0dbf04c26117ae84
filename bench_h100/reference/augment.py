"""The training augmentation, plainly: every random draw, then the
composed geometry (grid distortion, elastic field, affine with flips)
sampled once, then brightness/contrast, Gaussian noise, coarse dropout
and the normalisation to (x - 0.5) / 0.5.

The draws are the train loop's stream for (seed, step): numpy's
SeedSequence mixes both words into one 64-bit seed of a torch generator
on the images' device, and the draws are taken in the pipeline's order
and shapes. The sampling is written from its definition: the image
bilinear from the four taps around (r, c), with the lower tap clamped to
H-2 / W-2 and the whole pixel zero where (r, c) leaves the image; the
mask from the nearest tap, ties to the even index, zero outside.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# the augmentation of configs/lung_tumor.yaml: the YAML's keys, and the
# reference albumentations pipeline's fixed values for the rest
FIXED = dict(p_vflip=0.3, p_affine=0.5, translate=0.1, scale=(0.85, 1.15),
             alpha=50.0, sigma=10.0, p_grid=0.3, grid_steps=5,
             grid_limit=0.2, brightness=0.15, contrast=0.15, p_noise=0.2,
             noise_std=(0.01, 0.02), p_dropout=0.1, holes_max=4,
             hole_frac=(0.03, 0.06))


def generator(seed: int, step: int, device) -> torch.Generator:
    words = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(words[0]) << 32 | int(words[1]))
    return gen


def draws(n: int, h: int, w: int, yaml: Dict, gen: torch.Generator,
          device) -> Dict[str, torch.Tensor]:
    k = dict(generator=gen, device=device)
    c = FIXED

    def u(lo, hi, *shape):
        return torch.rand(*shape, **k) * (hi - lo) + lo

    def gate(p):
        return (torch.rand(n, **k) < p).float()

    rot = float(yaml.get('rotation_limit', 15))
    d = {}
    d['affine_on'] = gate(c['p_affine'])
    d['angle'] = u(-rot, rot, n)
    d['scale'] = u(*c['scale'], n)
    d['translate'] = u(-c['translate'], c['translate'], n, 2)
    d['hflip'] = gate(yaml.get('horizontal_flip', 0.5))
    d['vflip'] = gate(c['p_vflip'])
    d['elastic_on'] = gate(yaml.get('elastic', 0.3))
    d['el_dy'] = u(-1.0, 1.0, n, h, w)
    d['el_dx'] = u(-1.0, 1.0, n, h, w)
    d['grid_r_on'] = gate(c['p_grid'])
    d['grid_r'] = u(-c['grid_limit'], c['grid_limit'], n, c['grid_steps'])
    d['grid_c_on'] = gate(c['p_grid'])
    d['grid_c'] = u(-c['grid_limit'], c['grid_limit'], n, c['grid_steps'])
    d['bc_on'] = gate(yaml.get('brightness_contrast', 0.3))
    d['contrast'] = u(-c['contrast'], c['contrast'], n)
    d['brightness'] = u(-c['brightness'], c['brightness'], n)
    d['noise_on'] = gate(c['p_noise'])
    d['noise_std'] = u(*c['noise_std'], n)
    d['noise'] = torch.randn(n, 1, h, w, **k)
    d['drop_on'] = gate(c['p_dropout'])
    d['holes'] = torch.randint(1, c['holes_max'] + 1, (n,), **k)
    for name in ('hole_h', 'hole_w'):
        d[name] = u(*c['hole_frac'], n, c['holes_max'])
    d['hole_top'] = u(0.0, 1.0, n, c['holes_max'])
    d['hole_left'] = u(0.0, 1.0, n, c['holes_max'])
    return d


def _blur(field: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur, radius max(1, int(3 sigma)), zero
    padded."""
    r = max(1, int(3.0 * sigma))
    x = torch.arange(-r, r + 1, dtype=torch.float32, device=field.device)
    kern = torch.exp(-0.5 * (x / sigma) ** 2)
    kern = kern / kern.sum()
    f = F.conv2d(field[:, None], kern.view(1, 1, -1, 1), padding=(r, 0))
    f = F.conv2d(f, kern.view(1, 1, 1, -1), padding=(0, r))
    return f[:, 0]


def _grid_axis(on: torch.Tensor, raw: torch.Tensor, size: int,
               steps: int) -> torch.Tensor:
    """Source coordinate of each output index along one axis: the axis in
    ``steps`` equal cells, cell j stretched by (1 + raw_j) when on."""
    n = on.shape[0]
    factors = on[:, None] * (1.0 + raw) + (1.0 - on[:, None])
    cell = size / steps
    edges = torch.cat([torch.zeros(n, 1, device=raw.device),
                       torch.cumsum(factors * cell, -1)], -1)
    x = torch.arange(size, dtype=torch.float32, device=raw.device)
    j = torch.clamp(torch.floor(x / cell).long(), 0, steps - 1)
    frac = (x - j.float() * cell) / cell
    e0 = edges[:, j]
    e1 = edges[:, j + 1]
    return e0 + frac[None] * (e1 - e0)


def coordinates(d: Dict[str, torch.Tensor], h: int, w: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Source (rows, cols) of every output pixel, (N, H, W) each."""
    c = FIXED
    on = d['affine_on']
    angle = torch.deg2rad(d['angle']) * on
    scale = 1.0 + (d['scale'] - 1.0) * on
    t_r = d['translate'][:, 0] * on * h
    t_c = d['translate'][:, 1] * on * w
    sr = 1.0 - 2.0 * d['vflip']
    sc = 1.0 - 2.0 * d['hflip']
    cos, sin = torch.cos(angle) / scale, torch.sin(angle) / scale
    dy = _blur(d['el_dy'], c['sigma']) * c['alpha'] * d['elastic_on'][:, None, None]
    dx = _blur(d['el_dx'], c['sigma']) * c['alpha'] * d['elastic_on'][:, None, None]
    gr = _grid_axis(d['grid_r_on'], d['grid_r'], h, c['grid_steps'])
    gc = _grid_axis(d['grid_c_on'], d['grid_c'], w, c['grid_steps'])
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    pr = gr[:, :, None] + dy - t_r[:, None, None] - cy
    pc = gc[:, None, :] + dx - t_c[:, None, None] - cx
    v = lambda t: t[:, None, None]
    rows = v(cos * sr) * pr + v(sin * sc) * pc + cy
    cols = v(-sin * sr) * pr + v(cos * sc) * pc + cx
    return rows, cols


def sample(images: torch.Tensor, masks: torch.Tensor, rows: torch.Tensor,
           cols: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """images (N, H, W) float32, masks (N, H, W) uint8 at the source
    coordinates."""
    n, h, w = images.shape
    inside = (rows >= 0) & (rows <= h - 1) & (cols >= 0) & (cols <= w - 1)
    r = rows.clamp(0, h - 1)
    c = cols.clamp(0, w - 1)
    r0 = torch.floor(r).clamp(max=h - 2)
    c0 = torch.floor(c).clamp(max=w - 2)
    fr, fc = r - r0, c - c0
    r0, c0 = r0.long(), c0.long()
    flat = images.reshape(n, h * w)

    def at(ri, ci, src=flat):
        return torch.gather(src, 1, (ri * w + ci).reshape(n, -1)).view(n, h, w)

    img = (at(r0, c0) * (1 - fr) * (1 - fc) + at(r0, c0 + 1) * (1 - fr) * fc
           + at(r0 + 1, c0) * fr * (1 - fc) + at(r0 + 1, c0 + 1) * fr * fc)
    img = torch.where(inside, img, torch.zeros_like(img))
    rn = r0 + ((fr > 0.5) | ((fr == 0.5) & (r0 % 2 == 1))).long()
    cn = c0 + ((fc > 0.5) | ((fc == 0.5) & (c0 % 2 == 1))).long()
    msk = at(rn, cn, masks.reshape(n, h * w))
    msk = torch.where(inside, msk, torch.zeros_like(msk))
    return img, msk


def photometric(img: torch.Tensor, d: Dict[str, torch.Tensor]) -> torch.Tensor:
    n, h, w = img.shape
    v = lambda t: t[:, None, None]
    img = torch.clamp(img * (1.0 + v(d['contrast'] * d['bc_on']))
                      + v(d['brightness'] * d['bc_on']), 0.0, 1.0)
    img = torch.clamp(img + d['noise'][:, 0] * v(d['noise_std']
                                                 * d['noise_on']), 0.0, 1.0)
    hh, hw = d['hole_h'] * h, d['hole_w'] * w
    top, left = d['hole_top'] * (h - hh), d['hole_left'] * (w - hw)
    k = hh.shape[1]
    used = (torch.arange(k, device=img.device)[None] < d['holes'][:, None])
    used = used & (d['drop_on'][:, None] > 0)
    ys = torch.arange(h, dtype=torch.float32, device=img.device)
    xs = torch.arange(w, dtype=torch.float32, device=img.device)
    covered = torch.zeros(n, h, w, dtype=torch.bool, device=img.device)
    for j in range(k):
        in_r = (ys[None] >= top[:, j, None]) & (ys[None] < (top + hh)[:, j, None])
        in_c = (xs[None] >= left[:, j, None]) & (xs[None] < (left + hw)[:, j, None])
        covered |= (in_r[:, :, None] & in_c[:, None, :]
                    & used[:, j, None, None])
    return torch.where(covered, torch.zeros_like(img), img)


def augment(u8_images: torch.Tensor, masks: torch.Tensor, yaml: Dict,
            seed: int, step: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """u8_images (N, H, W) uint8, masks (N, H, W) uint8 -> (normalised
    float32 images (N, 1, H, W), masks (N, H, W) uint8)."""
    n, h, w = u8_images.shape
    d = draws(n, h, w, yaml, generator(seed, step, u8_images.device),
              u8_images.device)
    rows, cols = coordinates(d, h, w)
    img, msk = sample(u8_images.float() / 255.0, masks, rows, cols)
    img = photometric(img, d)
    return ((img - 0.5) / 0.5)[:, None], msk

