"""Shared helpers of the tests/test_torch_*.py files (not a test module)."""

import jax
import jax.numpy as jnp
import numpy as np
from flax.traverse_util import flatten_dict, unflatten_dict


def jax_variables(model, seed=0):
    """Variables in the flax model's tree (shapes from ``eval_shape``,
    no init compile) drawn from a numpy seed: convs U(+-1/sqrt(fan_in))
    as torch's init, and BatchNorm params and running stats away from
    their init values, so eval-mode normalization (and gate folding)
    does real work."""
    shapes = jax.eval_shape(
        lambda k: model.init(k, jnp.zeros((1, 32, 32, 1)), train=False),
        jax.random.key(0))
    rng = np.random.default_rng(seed)
    out = {}
    for coll in ('params', 'batch_stats'):
        flat = {}
        for path, sd in flatten_dict(dict(shapes[coll])).items():
            leaf, shape = path[-1], sd.shape
            if leaf == 'kernel':
                bound = 1.0 / np.sqrt(np.prod(shape[:-1]))
                a = rng.uniform(-bound, bound, shape)
            elif leaf in ('scale', 'var'):
                a = rng.uniform(0.5, 1.5, shape)
            else:  # bias, mean
                a = 0.1 * rng.standard_normal(shape)
            flat[path] = a.astype(np.float32)
        out[coll] = unflatten_dict(flat)
    return out


def jax_augment_params(key, cfg, n, h, w, c=1):
    """The draws ``unet_tpu.data.augmentations.augment_batch`` takes from
    ``key``, with its own key splits and helpers, as the port's
    ``AugmentParams`` (NCHW noise), so the port's ``apply_augment`` can be
    fed the JAX pipeline's randomness."""
    import torch
    from unet_tpu.data.augmentations import _bernoulli, _uniform
    from unet_tpu_torch.data.augmentations import AugmentParams

    keys = jax.random.split(key, 8)
    ka = jax.random.split(keys[0], 6)
    ke = jax.random.split(keys[1], 3)
    kgr, kgc = jax.random.split(keys[2])
    kr1, kr2 = jax.random.split(kgr)
    kc1, kc2 = jax.random.split(kgc)
    kb = jax.random.split(keys[3], 3)
    kn = jax.random.split(keys[4], 3)
    kd = jax.random.split(keys[5], 6)
    kmax, steps = cfg.dropout_holes_max, cfg.grid_steps
    draws = dict(
        affine_on=_bernoulli(ka[0], cfg.p_affine, n),
        angle_deg=_uniform(ka[1], -cfg.rotate_deg, cfg.rotate_deg, (n,)),
        scale=_uniform(ka[2], cfg.scale_min, cfg.scale_max, (n,)),
        translate=_uniform(ka[3], -cfg.translate_pct, cfg.translate_pct,
                           (n, 2)),
        hflip=_bernoulli(ka[4], cfg.p_hflip, n),
        vflip=_bernoulli(ka[5], cfg.p_vflip, n),
        elastic_on=_bernoulli(ke[2], cfg.p_elastic, n),
        elastic_dy=_uniform(ke[0], -1.0, 1.0, (n, h, w)),
        elastic_dx=_uniform(ke[1], -1.0, 1.0, (n, h, w)),
        grid_r_on=_bernoulli(kr2, cfg.p_grid, n),
        grid_r=_uniform(kr1, -cfg.grid_limit, cfg.grid_limit, (n, steps)),
        grid_c_on=_bernoulli(kc2, cfg.p_grid, n),
        grid_c=_uniform(kc1, -cfg.grid_limit, cfg.grid_limit, (n, steps)),
        bc_on=_bernoulli(kb[0], cfg.p_brightness, n),
        contrast=_uniform(kb[1], -cfg.contrast_limit, cfg.contrast_limit,
                          (n, 1, 1, 1)).reshape(n),
        brightness=_uniform(kb[2], -cfg.brightness_limit,
                            cfg.brightness_limit, (n, 1, 1, 1)).reshape(n),
        noise_on=_bernoulli(kn[0], cfg.p_noise, n),
        noise_std=_uniform(kn[1], cfg.noise_std_min, cfg.noise_std_max,
                           (n, 1, 1, 1)).reshape(n),
        noise=jax.random.normal(kn[2], (n, h, w, c)).transpose(0, 3, 1, 2),
        drop_on=_bernoulli(kd[0], cfg.p_dropout, n),
        holes=jax.random.randint(kd[1], (n,), 1, kmax + 1),
        hole_h=_uniform(kd[2], cfg.hole_frac_min, cfg.hole_frac_max,
                        (n, kmax)),
        hole_w=_uniform(kd[5], cfg.hole_frac_min, cfg.hole_frac_max,
                        (n, kmax)),
        hole_top=_uniform(kd[3], 0.0, 1.0, (n, kmax)),
        hole_left=_uniform(kd[4], 0.0, 1.0, (n, kmax)),
    )
    out = {}
    for k, v in draws.items():
        a = np.asarray(v)
        out[k] = torch.from_numpy(np.array(
            a.astype(np.int64) if k == 'holes' else a))
    return AugmentParams(**out)


def load_adam_state(opt, model, opt_state):
    """Carry optax AdamW moments (``mu``, ``nu`` and the step count of the
    ``ScaleByAdamState`` inside ``opt_state``) into the port's
    ``torch.optim.AdamW`` ``opt`` over ``model``, through the same name
    and layout mapping as the parameters."""
    import torch
    from unet_tpu_torch.utils.torch_port import state_dict_from_jax

    def find(node):
        if hasattr(node, 'mu') and hasattr(node, 'nu'):
            return node
        if hasattr(node, 'inner_state'):
            return find(node.inner_state)
        if isinstance(node, (tuple, list)):
            for child in node:
                found = find(child)
                if found is not None:
                    return found
        return None

    adam = find(opt_state)
    assert adam is not None, 'no ScaleByAdamState in opt_state'
    mu = state_dict_from_jax({'params': adam.mu})
    nu = state_dict_from_jax({'params': adam.nu})
    step = float(np.asarray(adam.count))
    for name, p in model.named_parameters():
        opt.state[p] = {'step': torch.tensor(step),
                        'exp_avg': mu[name].clone(),
                        'exp_avg_sq': nu[name].clone()}
