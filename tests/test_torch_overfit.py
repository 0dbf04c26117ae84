"""The port's overfit CLI (unet_tpu_torch/cli/overfit.py) on the CPU: it
passes at the verify recipe's size (--synthetic --img-size 64 --samples 2
--epochs 60 --base-features 8) for both models, writes the JAX CLI's
PNGs, and picks the same slices as the JAX CLI."""

import argparse
import re

import pytest
import torch

torch.set_num_threads(2)

RECIPE = ['--synthetic', '--img-size', '64', '--samples', '2', '--epochs',
          '60', '--base-features', '8', '--device', 'cpu']
PNGS = ('overfit_samples.png', 'overfit_curves.png',
        'overfit_predictions.png', 'overfit_overlay.png')


@pytest.mark.parametrize('model', ['unet', 'attention_unet'])
def test_port_overfit_passes(model, tmp_path, capsys):
    from unet_tpu_torch.cli import overfit
    from unet_tpu_torch.utils.plots import have_matplotlib
    rc = overfit.main([*RECIPE, '--model', model, '--output', str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert 'PASS: final tumor dice' in out
    if have_matplotlib():
        for name in PNGS:
            assert (tmp_path / name).stat().st_size > 0, name


def test_fail_returns_exit_code_1(tmp_path, capsys):
    """One epoch cannot reach the bar: main() reports FAIL with code 1."""
    from unet_tpu_torch.cli import overfit
    args = [a if a != '60' else '1' for a in RECIPE]
    assert overfit.main([*args, '--output', str(tmp_path)]) == 1
    assert 'FAIL: final tumor dice' in capsys.readouterr().out


def test_selects_the_same_slices_as_the_jax_cli(tmp_path, capsys):
    from unet_tpu.cli.overfit import run_overfit
    from unet_tpu.data import SyntheticSliceDataset as JaxSynthetic
    from unet_tpu_torch.cli import overfit
    from unet_tpu_torch.data.dataset import SyntheticSliceDataset

    kw = dict(num_volumes=4, slices_per_volume=4, img_size=64, split='all',
              tumor_prob=1.0, tumor_radius=(0.08, 0.15))
    for n in (2, 4):
        assert (overfit.select_samples(SyntheticSliceDataset(**kw), n)
                == overfit.select_samples(JaxSynthetic(**kw), n))

    jargs = argparse.Namespace(
        data='./dataset', samples=2, epochs=1, lr=1e-3, loss='dice_bce',
        model='unet', img_size=64, synthetic=True,
        output=str(tmp_path / 'jax'), base_features=4, device='cpu')
    run_overfit(jargs)
    jax_line = re.search(r'Selected .*', capsys.readouterr().out).group(0)
    res = overfit.run_overfit(overfit.parse_args(
        ['--synthetic', '--img-size', '64', '--samples', '2', '--epochs',
         '1', '--base-features', '4', '--device', 'cpu', '--output',
         str(tmp_path / 'port')]))
    port_line = re.search(r'Selected .*', capsys.readouterr().out).group(0)
    assert port_line == jax_line
    assert len(res['picked']) == 2
