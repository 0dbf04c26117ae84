"""The port's height-sharded eval forward (unet_tpu_torch/core/spatial.py)
on the CPU, over device lists that repeat the CPU, so every band, halo
exchange, regather and global-coordinate resize runs for real.

Tolerances:
* sharded against the port's own unsharded forward, float32: the
  tumor probabilities within atol 1e-5, the bound tests/test_parallel.py
  holds JAX's GSPMD spatial sharding to (the same float32 arithmetic,
  the resizes' taps blended in another order);
* the unsharded port forward against JAX's ``make_predict_step`` on the
  same carried-across weights: the f32 bound of the model tests
  (tests/test_torch_models.py, rtol 2e-2, atol 1e-3), and so the
  sharded forward within that of JAX's too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_tpu.models import create_model as jax_create_model
from unet_tpu.train.trainer import make_predict_step as jax_predict_step
from unet_tpu_torch.core.spatial import SpatialShardedModel, band_edges
from unet_tpu_torch.models import create_model
from unet_tpu_torch.train.trainer import make_predict_step
from unet_tpu_torch.utils.torch_port import state_dict_from_jax

from torch_port_helpers import jax_variables

torch.set_num_threads(2)

MODELS = [('attention_unet', True), ('unet', True), ('unet', False),
          ('attention_unet', False)]
# (height, width, bands): 32^2 over 2, 3, 4 and 8 bands (8 regather at
# the bottleneck: 2 rows over 8 bands), 48^2 over 2 (uneven bands: 32 and
# 16 rows), 40^2 over 8 (padded decoder rows, one band of padding only),
# 37 x 32 over 3 (odd heights at every level)
SHAPES = [(32, 32, 2), (32, 32, 3), (32, 32, 4), (32, 32, 8),
          (48, 48, 2), (40, 40, 8), (37, 32, 3)]


@pytest.mark.parametrize('height,bands,want', [
    (32, 2, [0, 16, 32]), (32, 3, [0, 16, 24, 32]),
    (32, 4, [0, 8, 16, 24, 32]), (32, 8, list(range(0, 33, 4))),
    (48, 2, [0, 32, 48]), (512, 4, [0, 128, 256, 384, 512]),
    (37, 3, [0, 16, 24, 37]), (5, 8, [0, 1, 2, 3, 4, 5])])
def test_band_edges(height, bands, want):
    assert band_edges(height, bands) == want


@pytest.fixture(scope='module')
def models():
    """Port models on JAX-drawn weights (BatchNorm statistics away from
    their init), with JAX's predict step on the same variables."""
    out = {}
    for kind, bilinear in MODELS:
        jm = jax_create_model(kind, bilinear=bilinear, base_features=4)
        variables = jax_variables(jm, seed=11)
        model = create_model(kind, bilinear=bilinear, base_features=4)
        model.load_state_dict(state_dict_from_jax(variables), strict=True)
        step = jax.jit(jax_predict_step(jm))
        out[kind, bilinear] = (
            model.eval(),
            lambda x, step=step, v=variables: np.asarray(step(
                v['params'], v['batch_stats'], jnp.asarray(x))))
    return out


@pytest.mark.parametrize('kind,bilinear', MODELS,
                         ids=[f'{k}-{"bilinear" if b else "transposed"}'
                              for k, b in MODELS])
@pytest.mark.parametrize('height,width,bands', SHAPES,
                         ids=[f'{h}x{w}-{n}' for h, w, n in SHAPES])
def test_sharded_forward_equals_unsharded(models, kind, bilinear, height,
                                          width, bands):
    model, _ = models[kind, bilinear]
    x = torch.from_numpy(np.random.default_rng(height + bands)
                         .standard_normal((2, 1, height, width))
                         .astype(np.float32))
    want = make_predict_step(model)(x)
    sharded = SpatialShardedModel(model, ['cpu'] * bands)
    got = make_predict_step(sharded)(x)
    assert got.shape == want.shape == (2, 2, height, width)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize('kind,bilinear', MODELS,
                         ids=[f'{k}-{"bilinear" if b else "transposed"}'
                              for k, b in MODELS])
def test_unsharded_forward_matches_jax_predict_step(models, kind,
                                                    bilinear):
    """The reference the sharded forward is held to is JAX's own."""
    model, jax_step = models[kind, bilinear]
    x = np.random.default_rng(5).standard_normal(
        (2, 32, 32, 1)).astype(np.float32)
    want = jax_step(x)
    got = make_predict_step(model)(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=2e-2, atol=1e-3)
    sharded = make_predict_step(SpatialShardedModel(model, ['cpu'] * 4))(
        torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(sharded.permute(0, 2, 3, 1).numpy(), want,
                               rtol=2e-2, atol=1e-3)


def test_fused_gate_model_takes_the_aten_route(monkeypatch):
    """A model built with the fused gate on, at 64^2 where the two
    widest gates (x 32^2 and 64^2) pass ``fused_shapes_supported``: the
    sharded forward takes the fused gate on every band of those gates, as
    the unsharded forward takes it there, and the ATen route at the two
    others; it equals the model's own forward."""
    from unet_tpu_torch.models import layers
    model = create_model('attention_unet', base_features=4,
                         use_fused_gate=True,
                         generator=torch.Generator().manual_seed(3)).eval()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 1, 64, 64)).astype(np.float32))
    calls, real = [], layers.attention_gate_fused

    def counting(g, xs, *args):
        calls.append((tuple(xs.shape[2:]), args[5:]))
        return real(g, xs, *args)

    monkeypatch.setattr(layers, 'attention_gate_fused', counting)
    want = make_predict_step(model)(x)
    assert calls == [((32, 32), (None,)), ((64, 64), (None,))]
    calls.clear()
    sharded = SpatialShardedModel(model, ['cpu', 'cpu', 'cpu'])
    got = make_predict_step(sharded)(x)
    # bands of 32, 16 and 16 rows at 64^2 (half that at 32^2), each with
    # the first g row it reads
    assert [(shape, band[0][:2]) for shape, band in calls] == [
        ((16, 32), (0, 0)), ((8, 32), (16, 7)), ((8, 32), (24, 11)),
        ((32, 64), (0, 0)), ((16, 64), (32, 15)), ((16, 64), (48, 23))]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize('kind,bilinear', MODELS,
                         ids=[f'{k}-{"bilinear" if b else "transposed"}'
                              for k, b in MODELS])
def test_sharded_forward_visits_every_submodule(models, kind, bilinear):
    """Every submodule, two levels down, that the model's own eval
    forward runs is run by the sharded forward too (a block added to
    ``models/unet.py`` and missing from ``core/spatial.py`` fails here),
    and the model's own forward runs every one of its children."""
    model, _ = models[kind, bilinear]
    x = torch.zeros(1, 1, 32, 32)

    def visited(fn):
        names, hooks = set(), []
        for name, mod in model.named_modules():
            if name:
                parts = name.split('.')
                hooks.append(mod.register_forward_pre_hook(
                    lambda m, a, p=parts: names.update(
                        ('.'.join(p[:1]), '.'.join(p[:2])))))
        try:
            with torch.inference_mode():
                fn(x)
        finally:
            for h in hooks:
                h.remove()
        return names

    want = visited(model)
    assert {n for n, _ in model.named_children()} <= want
    assert visited(SpatialShardedModel(model, ['cpu', 'cpu'])) == want


def test_refuses_other_models():
    with pytest.raises(TypeError, match='UNet'):
        SpatialShardedModel(torch.nn.Conv2d(1, 1, 3), ['cpu'])
