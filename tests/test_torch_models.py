"""The port's models (unet_tpu_torch/models) and weight mapping
(unet_tpu_torch/utils/torch_port.py) against the JAX package: parameter
counts, state dicts, and eval logits of the flax model from the same
weights (NHWC <-> NCHW at the boundary)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_tpu.models import create_model as jax_create_model
from unet_tpu.utils.torch_port import export_torch_state_dict
from unet_tpu_torch.models import create_model
from unet_tpu_torch.models import layers
from unet_tpu_torch.utils.torch_port import state_dict_from_jax
from torch_port_helpers import jax_variables

torch.set_num_threads(2)

# reference torch model counts (tests/test_models.py:20-26)
PARAM_COUNTS = {
    ('unet', True): 17_261_890,
    ('unet', False): 31_036_546,
    ('attention_unet', True): 17_612_458,
    ('attention_unet', False): 31_561_194,
}
ATTENTION_DS_BILINEAR = 17_613_360


@pytest.mark.parametrize('model_type,bilinear', list(PARAM_COUNTS))
def test_param_count_parity(model_type, bilinear):
    model = create_model(model_type, bilinear=bilinear)
    want = PARAM_COUNTS[(model_type, bilinear)]
    assert model.get_num_params() == want
    assert model.get_num_params(trainable_only=False) == want


def test_param_count_deep_supervision():
    model = create_model('attention_unet', deep_supervision=True)
    assert model.get_num_params() == ATTENTION_DS_BILINEAR


def _port_model(model_type, variables, **kw):
    model = create_model(model_type, **kw)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model.eval()


@pytest.mark.parametrize('model_type', ['unet', 'attention_unet'])
@pytest.mark.parametrize('bilinear', [True, False])
def test_state_dict_from_jax_equals_export(model_type, bilinear):
    """Same keys, shapes and values (bit for bit) as the JAX package's
    exporter, and a strict load into the port's model."""
    jm = jax_create_model(model_type, bilinear=bilinear, base_features=8)
    variables = jax_variables(jm)
    want = export_torch_state_dict(variables)
    got = state_dict_from_jax(variables)
    assert set(got) == set(want)
    for k, v in want.items():
        g = got[k].numpy()
        assert g.shape == np.shape(v), k
        assert g.dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(g, v, err_msg=k)
    model = create_model(model_type, bilinear=bilinear, base_features=8)
    model.load_state_dict(got, strict=True)


def _compare_logits(model_type, bilinear, hw, *, dtype=jnp.float32,
                    tdtype=torch.float32, rtol=2e-2, atol=1e-3, seed=0):
    jm = jax_create_model(model_type, bilinear=bilinear, base_features=8,
                          dtype=dtype)
    variables = jax_variables(jm, seed)
    x = np.random.default_rng(seed + 2).standard_normal(
        (2, hw, hw, 1)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        variables, jnp.asarray(x)))
    model = _port_model(model_type, variables, bilinear=bilinear,
                        base_features=8, dtype=tdtype)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    return got, want


# tolerance (as tests/test_models.py:143-146): the two frameworks' convs
# reduce in different orders, and f32 noise of O(1e-4) accumulates over
# the 23-conv stack; a wiring error gives O(1) differences.
@pytest.mark.parametrize('model_type,bilinear,hw', [
    ('unet', True, 64),
    ('unet', False, 50),
    ('attention_unet', True, 64),
    ('attention_unet', False, 64),
    ('attention_unet', True, 36),   # every decoder level padded
    ('attention_unet', True, 50),   # odd at a deeper level
])
def test_eval_logits_match_flax(model_type, bilinear, hw):
    _compare_logits(model_type, bilinear, hw)


def test_eval_logits_match_flax_bf16():
    """bf16 compute on both sides. Each side rounds every conv output and
    BatchNorm step to bf16 (8 significant bits, relative step 2^-8), but
    not at the same points: the JAX decoder convs are two channel-sliced
    convs summed in bf16, the port's one conv over the concat, and XLA
    may keep a fused elementwise chain in f32. Differences of a few bf16
    steps per layer compound over 23 convs (0.55% of the logits' range
    measured at this seed), so the logits are held to 2% of their range;
    a wiring error is O(1) of it."""
    got, want = _compare_logits('attention_unet', True, 64,
                                dtype=jnp.bfloat16, tdtype=torch.bfloat16,
                                rtol=0, atol=np.inf)
    scale = np.abs(want).max()
    assert scale > 0.1
    assert np.abs(got - want).max() <= 0.02 * scale


@pytest.mark.parametrize('bilinear', [True, False])
def test_fused_gate_model_matches_jax_fused_path(bilinear, monkeypatch,
                                                 capsys):
    """The slice's configuration, small: AttentionUNet with the fused
    gate at 256^2, the smallest input at which all four gates pass the
    guard, bilinear and transposed (whose gates take the un-upsampled
    decoder map: Cg = 2 Cx). The JAX side runs its Pallas kernel in
    interpret mode (as tests/test_pallas.py:66,79 do; the TPU backend
    flag also switches its resize and psi to their matmul forms, which
    compute the same function); the port folds BatchNorm the same way and
    runs the kernel's plain version on the CPU."""
    from jax.experimental.pallas import tpu as pltpu

    jm = jax_create_model('attention_unet', base_features=4,
                          bilinear=bilinear, use_fused_gate=True)
    variables = jax_variables(jm, seed=3)
    x = np.random.default_rng(5).standard_normal(
        (1, 256, 256, 1)).astype(np.float32)

    monkeypatch.setattr(jax, 'default_backend', lambda: 'tpu')
    monkeypatch.setenv('UNET_TPU_DEBUG_FUSED', '1')
    capsys.readouterr()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    assert capsys.readouterr().out.count('[fused gate]') == 4

    fused_calls = []
    real = layers.attention_gate_fused
    monkeypatch.setattr(
        layers, 'attention_gate_fused',
        lambda *a: fused_calls.append((a[0].shape[1], a[1].shape[1],
                                       a[1].shape[2])) or real(*a))
    model = _port_model('attention_unet', variables, base_features=4,
                        bilinear=bilinear, use_fused_gate=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    ratio = 1 if bilinear else 2
    assert fused_calls == [(ratio * c, c, h) for c, h in
                           ((32, 32), (16, 64), (8, 128), (4, 256))]
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=2e-2, atol=1e-3)


def test_train_mode_is_not_ported_yet():
    """Train mode is ported now (the name is kept from when it raised): a
    fresh model is in training mode, and its forward normalizes with the
    batch statistics and moves the running ones. tests/test_torch_train.py
    holds train mode against flax."""
    model = create_model('unet', base_features=4)
    assert model.training
    bn = model.inc.double_conv[1]
    x = torch.randn(2, 1, 32, 32, generator=torch.Generator().manual_seed(0))
    out = model(x)
    assert out.shape == (2, 2, 32, 32) and torch.isfinite(out).all()
    assert not torch.equal(bn.running_mean, torch.zeros(4))
    assert int(bn.num_batches_tracked) == 1
