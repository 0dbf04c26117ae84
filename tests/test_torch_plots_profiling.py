"""The port's plotting and profiling utilities (unet_tpu_torch/utils/
{plots,profiling}.py) on the CPU: every plot of the JAX package's
module is drawn from NCHW tensors and numpy arrays alike, with the same
artifact layout; the profiler writes a Chrome trace only when given a
directory; the NaN guard behaves as documented. The program's spans:
tests/test_torch_spans.py."""

import json

import numpy as np
import pytest
import torch

from unet_tpu_torch.utils import plots, profiling

torch.set_num_threads(2)


@pytest.fixture
def batch(rng):
    images = rng.standard_normal((3, 1, 16, 16)).astype(np.float32)
    masks = (rng.random((3, 16, 16)) > 0.7).astype(np.int64)
    logits = rng.standard_normal((3, 2, 16, 16)).astype(np.float32)
    return images, masks, logits


@pytest.mark.parametrize('as_tensor', [False, True])
def test_every_plot_is_written(batch, tmp_path, as_tensor):
    if not plots.have_matplotlib():
        pytest.fail('matplotlib is installed here; the plots must be drawn')
    images, masks, logits = batch
    if as_tensor:
        images, masks, logits = map(torch.from_numpy, (images, masks, logits))
    history = {'train_loss': [1.0, 0.8], 'val_loss': [1.1, 0.9],
               'val_dice': [0.2, 0.4], 'tumor_dice': [0.1, 0.3],
               'val_iou': [0.1, 0.2]}
    files = {
        'curves.png': lambda p: plots.plot_training_curves(history, p),
        'grid.png': lambda p: plots.plot_predictions(images, masks, logits,
                                                     num_samples=2,
                                                     save_path=p),
        'one.png': lambda p: plots.plot_predictions(images, masks, masks,
                                                    num_samples=1,
                                                    save_path=p),
        'cm.png': lambda p: plots.plot_confusion_matrix(
            np.array([[50, 5], [3, 12]]), ['background', 'tumor'],
            save_path=p),
        'overlay.png': lambda p: plots.plot_sample_with_overlay(
            images[0], masks[0], masks[1], save_path=p),
    }
    for name, draw in files.items():
        assert draw(tmp_path / 'sub' / name) is None
        assert (tmp_path / 'sub' / name).stat().st_size > 0, name


def test_plots_need_matplotlib(monkeypatch):
    monkeypatch.setattr(plots, 'have_matplotlib', lambda: False)
    with pytest.raises(ImportError, match='matplotlib'):
        plots.plot_training_curves({'train_loss': [1.0]})


def test_trace_is_a_no_op_without_a_directory(tmp_path):
    with profiling.trace(None) as prof:
        assert prof is None
    with profiling.trace('') as prof:
        assert prof is None
    assert list(tmp_path.iterdir()) == []


def test_trace_writes_a_chrome_trace_with_annotations(tmp_path):
    out = tmp_path / 'trace'
    with profiling.trace(str(out)):
        with profiling.annotate('my_region'):
            torch.ones(8, 8) @ torch.ones(8, 8)
    traces = list(out.glob('trace_*.json'))
    assert len(traces) == 1
    names = {e.get('name') for e in
             json.loads(traces[0].read_text())['traceEvents']}
    assert 'my_region' in names and 'aten::mm' in names


def test_nan_guard():
    profiling.nan_guard(False).check_finite(torch.tensor(float('nan')), 'x')
    guard = profiling.nan_guard(True)
    guard.check_finite(torch.tensor([1.0, 2.0]), 'loss')
    with pytest.raises(FloatingPointError, match='non-finite loss'):
        guard.check_finite(torch.tensor([1.0, float('inf')]), 'loss')
