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
