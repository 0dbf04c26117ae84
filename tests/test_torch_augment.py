"""The port's augmentation (unet_tpu_torch/data/augmentations.py) against
the JAX package's `augment_batch`.

torch cannot reproduce jax.random streams, so each stage of the port is
fed the JAX pipeline's own draws (taken with `augment_batch`'s key
splits, tests/torch_port_helpers.py::jax_augment_params) and held
against the JAX stage. The port's own draws are held by their
distribution, as tests/test_augment_formulas.py holds the JAX ones.

Tolerances: the affine, grid and photometric stages repeat the same
float32 operations (rtol 1e-6 / atol 1e-6). The elastic smoothing (61
taps, sums in another order) and the composed coordinates are held to
1e-4 px. Through the full pipeline a coordinate that lands within that
of an integer or a half may floor or round the other way, so masks may
differ there and only there (and at most at 0.1% of pixels); images are
held to 5e-4 (1e-4 px times the normalize's gain of 2, plus the
photometric ops) away from the border pixels whose validity can flip.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import unet_tpu.data.augmentations as jaug
from unet_tpu_torch.data import augmentations as aug
from torch_port_helpers import jax_augment_params

torch.set_num_threads(2)

N, H, W = 4, 48, 64
COORD_TOL = 1e-4
ALL_ON = dict(p_hflip=1.0, p_vflip=1.0, p_affine=1.0, p_elastic=1.0,
              p_grid=1.0, p_brightness=1.0, p_noise=1.0, p_dropout=1.0)
GEOMETRY_OFF = dict(p_hflip=0.0, p_vflip=0.0, p_affine=0.0, p_elastic=0.0,
                    p_grid=0.0)


def _cfgs(**kw):
    return (jaug.AugmentConfig(**kw), aug.AugmentConfig(**kw))


def _batch(seed, n=N, h=H, w=W):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.2, 0.8, (n, h, w, 1)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    msk = np.stack([((yy - h / 2) ** 2 + (xx - w / 3 - i) ** 2 < 90)
                    for i in range(n)]).astype(np.int32)
    return img, msk


def _nchw(img):
    return torch.from_numpy(img).permute(0, 3, 1, 2).contiguous()


@pytest.mark.parametrize('kw', [{}, ALL_ON], ids=['default', 'all_on'])
def test_affine_maps_match_jax(kw):
    jcfg, tcfg = _cfgs(**kw)
    key = jax.random.key(1)
    p = jax_augment_params(key, jcfg, N, H, W)
    lin, t = jaug._affine_matrices(jax.random.split(key, 8)[0], jcfg, N, H,
                                   W)
    got_lin, got_t = aug.affine_maps(p, H, W)
    np.testing.assert_allclose(got_lin.numpy(), np.asarray(lin), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(t), rtol=1e-6,
                               atol=1e-6)


def test_elastic_displacement_matches_jax():
    jcfg, tcfg = _cfgs(p_elastic=1.0)
    key = jax.random.key(2)
    p = jax_augment_params(key, jcfg, N, H, W)
    dy, dx = jaug._elastic_displacement(jax.random.split(key, 8)[1], jcfg,
                                        N, H, W)
    got_dy, got_dx = aug.elastic_displacement(p, tcfg)
    assert np.abs(np.asarray(dy)).max() > 0.1  # the field does move pixels
    np.testing.assert_allclose(got_dy.numpy(), np.asarray(dy), rtol=0,
                               atol=COORD_TOL)
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(dx), rtol=0,
                               atol=COORD_TOL)


def test_gaussian_kernel_matches_jax():
    want = np.asarray(jaug._gaussian_kernel1d(10.0, 30))
    got = aug.gaussian_kernel1d(10.0, 30, torch.device('cpu')).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize('size', [H, W, 37])
def test_grid_distortion_map_matches_jax(size):
    """Float floor division for the cell index and no renormalization:
    the distorted map may run past the border."""
    jcfg, _ = _cfgs(p_grid=1.0)
    key = jax.random.key(3)
    kgr = jax.random.split(jax.random.split(key, 8)[2])[0]
    want = np.asarray(jaug._grid_distortion_map(kgr, jcfg, N, size, 0))
    k1, k2 = jax.random.split(kgr)
    apply = torch.from_numpy(np.asarray(jaug._bernoulli(k2, 1.0, N)))
    factors = torch.from_numpy(np.asarray(jaug._uniform(
        k1, -jcfg.grid_limit, jcfg.grid_limit, (N, jcfg.grid_steps))))
    got = aug.grid_distortion_map(apply, factors, size, jcfg.grid_steps)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)
    assert np.abs(want[:, -1] - (size - 1)).max() > 0.1  # not renormalized


def _jax_pipeline(img, msk, key, jcfg):
    """JAX ``augment_batch`` (unjitted, XLA warp path), with the
    coordinates it composes captured on the way to the warp."""
    seen = {}
    real = jaug._grid_sample_fused

    def capture(images, masks, rows, cols):
        seen['rows'], seen['cols'] = np.asarray(rows), np.asarray(cols)
        return real(images, masks, rows, cols)

    jaug._grid_sample_fused = capture
    try:
        out_i, out_m = jaug.augment_batch.__wrapped__(
            jnp.asarray(img), jnp.asarray(msk), key, jcfg)
    finally:
        jaug._grid_sample_fused = real
    return np.asarray(out_i), np.asarray(out_m), seen['rows'], seen['cols']


def _near_tie(x, h):
    """Coordinates within COORD_TOL of an integer or a half (where floor,
    the .5 tie or the border test can flip)."""
    f = np.asarray(x, np.float64) * 2
    return np.abs(f - np.round(f)) < 2 * COORD_TOL


@pytest.mark.parametrize('kw,seed', [({}, 4), (ALL_ON, 5), (ALL_ON, 6)],
                         ids=['default', 'all_on', 'all_on_2'])
def test_full_pipeline_matches_jax_on_jax_draws(kw, seed):
    jcfg, tcfg = _cfgs(**kw)
    img, msk = _batch(seed)
    key = jax.random.key(seed)
    want_i, want_m, rows, cols = _jax_pipeline(img, msk, key, jcfg)
    p = jax_augment_params(key, jcfg, N, H, W)

    got_rows, got_cols = aug.sampling_grid(p, tcfg, H, W)
    np.testing.assert_allclose(got_rows.numpy(), rows, rtol=0, atol=COORD_TOL)
    np.testing.assert_allclose(got_cols.numpy(), cols, rtol=0, atol=COORD_TOL)

    got_i, got_m = aug.apply_augment(_nchw(img), torch.from_numpy(
        msk.astype(np.uint8)), p, tcfg)
    got_i = got_i.permute(0, 2, 3, 1).numpy()
    got_m = got_m.numpy().astype(np.int32)
    fragile = _near_tie(rows, H) | _near_tie(cols, W)
    differ = got_m != want_m
    assert differ.mean() <= 1e-3, differ.mean()
    assert not (differ & ~fragile).any()
    assert (want_m > 0).sum() > 50  # the masks carry labels through
    border = ((np.abs(rows) < COORD_TOL) | (np.abs(rows - (H - 1)) < COORD_TOL)
              | (np.abs(cols) < COORD_TOL)
              | (np.abs(cols - (W - 1)) < COORD_TOL))
    np.testing.assert_allclose(got_i[..., 0][~border], want_i[..., 0][~border],
                               rtol=0, atol=5e-4)


def test_photometric_chain_matches_jax():
    """Geometry off (identity grid): brightness/contrast, noise, dropout
    and normalize repeat JAX's float32 operations."""
    jcfg, tcfg = _cfgs(**{**GEOMETRY_OFF, 'p_brightness': 1.0,
                          'p_noise': 1.0, 'p_dropout': 1.0})
    img, msk = _batch(7)
    key = jax.random.key(7)
    want_i, want_m, _, _ = _jax_pipeline(img, msk, key, jcfg)
    p = jax_augment_params(key, jcfg, N, H, W)
    got_i, got_m = aug.apply_augment(_nchw(img), torch.from_numpy(
        msk.astype(np.uint8)), p, tcfg)
    np.testing.assert_array_equal(got_m.numpy(), want_m)
    np.testing.assert_allclose(got_i.permute(0, 2, 3, 1).numpy(), want_i,
                               rtol=0, atol=1e-6)


def test_coarse_dropout_matches_jax():
    jcfg, _ = _cfgs(p_dropout=1.0)
    img, _ = _batch(8)
    key = jax.random.key(8)
    want = np.asarray(jaug._coarse_dropout(jax.random.split(key, 8)[5],
                                           jnp.asarray(img), jcfg))
    p = jax_augment_params(key, jcfg, N, H, W)
    got = aug.coarse_dropout(_nchw(img), p).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 0).any()


def test_multichannel_pipeline_matches_jax():
    """C > 1 takes the plain bilinear/nearest pair in both packages."""
    jcfg, tcfg = _cfgs(**ALL_ON)
    rng = np.random.default_rng(9)
    img = rng.uniform(0.2, 0.8, (2, H, W, 3)).astype(np.float32)
    _, msk = _batch(9, n=2)
    key = jax.random.key(9)
    want_i, want_m = jaug.augment_batch.__wrapped__(
        jnp.asarray(img), jnp.asarray(msk), key, jcfg)
    p = jax_augment_params(key, jcfg, 2, H, W, c=3)
    got_i, got_m = aug.apply_augment(_nchw(img), torch.from_numpy(
        msk.astype(np.uint8)), p, tcfg)
    differ = got_m.numpy() != np.asarray(want_m)
    assert differ.mean() <= 1e-3
    close = np.isclose(got_i.permute(0, 2, 3, 1).numpy(), np.asarray(want_i),
                       rtol=0, atol=5e-4)
    assert close.mean() >= 0.999


def test_from_yaml_matches_jax():
    with open('configs/lung_tumor.yaml') as f:
        section = yaml.safe_load(f)['augmentation']
    for sec in (section, {}, None, {'vertical_flip': 0.0, 'affine': 0.25}):
        assert (dataclasses.asdict(aug.AugmentConfig.from_yaml(sec))
                == dataclasses.asdict(jaug.AugmentConfig.from_yaml(sec)))


# ------------------------------------------------- the port's own draws

def _draw(n, cfg, seed=0, h=8, w=8):
    gen = torch.Generator().manual_seed(seed)
    return aug.draw_augment_params(n, h, w, cfg, gen, torch.device('cpu'))


def test_draw_gate_rates():
    """Each gate is Bernoulli(p): within 4.5 sigma of p over 8000 draws."""
    cfg = aug.AugmentConfig()
    n = 8000
    p = _draw(n, cfg)
    rates = {'affine_on': cfg.p_affine, 'hflip': cfg.p_hflip,
             'vflip': cfg.p_vflip, 'elastic_on': cfg.p_elastic,
             'grid_r_on': cfg.p_grid, 'grid_c_on': cfg.p_grid,
             'bc_on': cfg.p_brightness, 'noise_on': cfg.p_noise,
             'drop_on': cfg.p_dropout}
    for name, rate in rates.items():
        got = getattr(p, name)
        assert set(got.unique().tolist()) <= {0.0, 1.0}
        sigma = (rate * (1 - rate) / n) ** 0.5
        assert abs(got.mean().item() - rate) < 4.5 * sigma, name


def test_draw_ranges_and_independent_hole_sizes():
    cfg = aug.AugmentConfig()
    p = _draw(4000, cfg)
    ranges = {'angle_deg': (-cfg.rotate_deg, cfg.rotate_deg),
              'scale': (cfg.scale_min, cfg.scale_max),
              'translate': (-cfg.translate_pct, cfg.translate_pct),
              'elastic_dy': (-1.0, 1.0), 'elastic_dx': (-1.0, 1.0),
              'grid_r': (-cfg.grid_limit, cfg.grid_limit),
              'contrast': (-cfg.contrast_limit, cfg.contrast_limit),
              'brightness': (-cfg.brightness_limit, cfg.brightness_limit),
              'noise_std': (cfg.noise_std_min, cfg.noise_std_max),
              'hole_h': (cfg.hole_frac_min, cfg.hole_frac_max),
              'hole_w': (cfg.hole_frac_min, cfg.hole_frac_max),
              'hole_top': (0.0, 1.0), 'hole_left': (0.0, 1.0)}
    for name, (lo, hi) in ranges.items():
        v = getattr(p, name)
        assert v.min().item() >= lo and v.max().item() <= hi, name
        # uniform: the mean sits mid-range, both ends are reached
        assert abs(v.mean().item() - (lo + hi) / 2) < 0.03 * (hi - lo), name
        assert v.min().item() < lo + 0.02 * (hi - lo), name
    assert set(p.holes.unique().tolist()) == set(
        range(1, cfg.dropout_holes_max + 1))
    corr = np.corrcoef(p.hole_h.flatten().numpy(),
                       p.hole_w.flatten().numpy())[0, 1]
    assert abs(corr) < 0.05
    assert abs(p.noise.mean().item()) < 0.05
    assert abs(p.noise.std().item() - 1.0) < 0.05


def test_generator_for_step_streams():
    cfg = aug.AugmentConfig()
    dev = torch.device('cpu')
    a = aug.draw_augment_params(4, 8, 8, cfg,
                                aug.generator_for_step(43, 0, dev), dev)
    b = aug.draw_augment_params(4, 8, 8, cfg,
                                aug.generator_for_step(43, 0, dev), dev)
    c = aug.draw_augment_params(4, 8, 8, cfg,
                                aug.generator_for_step(43, 1, dev), dev)
    assert torch.equal(a.elastic_dy, b.elastic_dy)
    assert not torch.equal(a.elastic_dy, c.elastic_dy)


def test_identity_config_is_exact():
    """Everything off, mean 0 / std 1: images and masks come back
    bit-identical, through the same warp as the train path."""
    cfg = aug.AugmentConfig(**{**{k: 0.0 for k in ALL_ON}, 'mean': 0.0,
                               'std': 1.0})
    img, msk = _batch(10)
    m8 = torch.from_numpy(msk.astype(np.uint8))
    out_i, out_m = aug.augment_batch_seeded(_nchw(img), m8, 43, 0, cfg)
    assert torch.equal(out_i, _nchw(img)) and torch.equal(out_m, m8)
