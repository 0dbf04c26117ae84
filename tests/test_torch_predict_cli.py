"""Both directory predict CLIs on one reference-format .pt on the CPU:
``unet_tpu.cli.predict`` and the port's ``unet_tpu_torch.cli.predict``,
at --img-size 64 with a threshold sweep and --save-overlay, over a
directory holding grayscale PNGs of several sizes, an RGB PNG, a JPEG
and a corrupt PNG. They must write the same set of files, skip the
corrupt one, and agree on every mask pixel except those whose
probability lies within 1e-3 of the threshold (the two frameworks' f32
convolutions sum in other orders). The thresholds are the quartiles of
the model's own tumor probabilities, so each cuts through the masks."""

import sys
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

torch.set_num_threads(2)

IMG = 64


@torch.no_grad()
def _calibrate(model, x):
    """Give each BatchNorm the statistics of its own input (so every
    layer sees normalized activations), then spread the head's logits
    around 0, so tumor probabilities cover (0, 1) instead of sitting at
    one value."""
    from unet_tpu_torch.models.layers import TorchBatchNorm

    def hook(bn, inputs):
        bn.running_mean.copy_(inputs[0].mean((0, 2, 3)))
        bn.running_var.copy_(inputs[0].var((0, 2, 3)))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, TorchBatchNorm)]
    model(x)
    for h in handles:
        h.remove()
    d = model(x)[:, 1] - model(x)[:, 0]
    model.outc.conv.weight[1] *= 4.0 / float(d.std())
    model.outc.conv.bias[1] -= float((model(x)[:, 1] - model(x)[:, 0])
                                     .median())


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    from unet_tpu_torch.cli.predict import load_model, preprocess_image
    from unet_tpu_torch.models import create_model
    from unet_tpu_torch.train.trainer import make_predict_step_u8

    tmp = tmp_path_factory.mktemp('predict')
    src = tmp / 'imgs'
    src.mkdir()
    rng = np.random.default_rng(0)

    def smooth(h, w, c=None):
        shape = (max(2, h // 8), max(2, w // 8)) + ((c,) if c else ())
        small = (rng.random(shape) * 255).astype(np.uint8)
        return Image.fromarray(small).resize((w, h), Image.BILINEAR)

    smooth(64, 64).save(src / 'a_gray.png')
    smooth(50, 80).save(src / 'b_gray_wide.png')
    smooth(96, 72).save(src / 'c_gray_tall.png')
    smooth(70, 90, 3).save(src / 'd_rgb.png')
    smooth(64, 64).save(src / 'e_photo.jpg', quality=90)
    (src / 'f_corrupt.png').write_bytes(b'\x89PNG\r\n\x1a\nnot a real png')
    good = [f for f in sorted(src.iterdir()) if not f.name.startswith('f_')]
    u8 = np.stack([preprocess_image(f, IMG)[0] for f in good])

    cfg = {'model': {'type': 'attention_unet', 'n_channels': 1,
                     'n_classes': 2, 'bilinear': True, 'base_features': 8,
                     'deep_supervision': False},
           'tpu': {'compute_dtype': 'float32',
                   'fused_attention_gate': True}}
    model = create_model('attention_unet', base_features=8,
                         generator=torch.Generator().manual_seed(0)).eval()
    _calibrate(model, (torch.from_numpy(u8).float() / 255.0 - 0.5) / 0.5)
    pt = tmp / 'model.pt'
    torch.save({'epoch': 3, 'model_state_dict': model.state_dict(),
                'optimizer_state_dict': {}, 'metrics': {}, 'config': cfg},
               pt)

    # thresholds at the quartiles of the model's tumor probabilities
    port_model, _ = load_model(pt, device='cpu')
    step = make_predict_step_u8(port_model)
    probs = {}
    for f in good:
        x, orig = preprocess_image(f, IMG)
        probs[f.stem] = (step(torch.from_numpy(x[None].copy()))[0, 1].numpy(),
                         orig)
    allp = np.concatenate([p.ravel() for p, _ in probs.values()])
    thresholds = [round(float(q), 3) for q in
                  np.quantile(allp, [0.5, 0.25, 0.75])]
    assert len(set(thresholds)) == 3
    return {'tmp': tmp, 'pt': pt, 'src': src, 'probs': probs,
            'thresholds': thresholds}


def _argv(setup, out, *extra):
    return ['--weights', str(setup['pt']), '--source', str(setup['src']),
            '--output', str(out), '--img-size', str(IMG), '--threshold',
            ','.join(f'{t:g}' for t in setup['thresholds']),
            '--save-overlay', '--batch-size', '2', *extra]


@pytest.fixture(scope='module')
def outputs(setup):
    from unet_tpu.cli.predict import main as jax_main
    from unet_tpu_torch.ops import attention_gate
    from unet_tpu_torch.cli.predict import main as port_main

    jax_out, port_out = setup['tmp'] / 'jax', setup['tmp'] / 'port'
    old = sys.argv
    sys.argv = ['predict', *_argv(setup, jax_out)]
    try:
        jax_main()
    finally:
        sys.argv = old
    before = attention_gate.launch_count
    summary = port_main(_argv(setup, port_out, '--device', 'cpu'))
    assert attention_gate.launch_count == before  # CPU: no kernel launch
    return jax_out, port_out, summary


def test_same_files_and_the_corrupt_one_skipped(setup, outputs):
    jax_out, port_out, summary = outputs
    got = sorted(p.name for p in port_out.iterdir())
    assert got == sorted(p.name for p in jax_out.iterdir())
    stems = ['a_gray', 'b_gray_wide', 'c_gray_tall', 'd_rgb', 'e_photo']
    t = setup['thresholds']
    want = sorted([f'{s}_mask.png' for s in stems]
                  + [f'{s}_overlay.png' for s in stems]
                  + [f'{s}_mask_t{x:g}.png' for s in stems for x in t[1:]])
    assert got == want
    assert summary['processed'] == 5 and summary['files'] == 6
    assert [p.rsplit('/', 1)[-1] for p in summary['skipped']] == [
        'f_corrupt.png']
    assert summary['chunks'] == 3  # 6 files in chunks of 2


def test_masks_agree_except_at_the_threshold(setup, outputs):
    jax_out, port_out, _ = outputs
    t = setup['thresholds']
    suffixes = [('_mask.png', t[0])] + [(f'_mask_t{x:g}.png', x)
                                        for x in t[1:]]
    tumor = {suffix: [] for suffix, _ in suffixes}
    for stem, (prob, orig) in setup['probs'].items():
        for suffix, thr in suffixes:
            a = np.asarray(Image.open(port_out / f'{stem}{suffix}'))
            b = np.asarray(Image.open(jax_out / f'{stem}{suffix}'))
            assert a.shape == b.shape == (orig[1], orig[0])
            assert set(np.unique(a)) <= {0, 255}
            near = Image.fromarray((np.abs(prob - thr) < 1e-3).astype(
                np.uint8)).resize(orig, Image.NEAREST)
            differ = a != b
            assert not (differ & ~(np.asarray(near) > 0)).any(), (stem,
                                                                   suffix)
            tumor[suffix].append((a > 0).mean())
    for suffix, shares in tumor.items():  # each threshold cuts the masks
        assert 0 < np.mean(shares) < 1, (suffix, shares)


def test_overlays_are_rgb_at_the_original_size(setup, outputs):
    _, port_out, _ = outputs
    for stem, (_, orig) in setup['probs'].items():
        ov = Image.open(port_out / f'{stem}_overlay.png')
        assert ov.mode == 'RGB' and ov.size == orig


def test_pil_decode_gives_the_same_masks(setup, outputs, tmp_path):
    """--no-native-decode routes every file through PIL; the native stage
    is bit-exact with PIL, so the masks are identical."""
    from unet_tpu_torch.cli.predict import main as port_main
    _, port_out, _ = outputs
    port_main(_argv(setup, tmp_path, '--device', 'cpu',
                    '--no-native-decode'))
    for p in port_out.glob('*_mask*.png'):
        np.testing.assert_array_equal(np.asarray(Image.open(p)),
                                      np.asarray(Image.open(tmp_path / p.name)))


def test_spatial_shard_stops_at_parsing(capsys):
    from unet_tpu_torch.cli.predict import parse_args
    with pytest.raises(SystemExit):
        parse_args(['--weights', 'w.pt', '--source', 's', '--spatial-shard'])
    assert '--spatial-shard' in capsys.readouterr().err


def test_cuda_is_required_unless_cpu_is_asked(setup, tmp_path, monkeypatch):
    from unet_tpu_torch.cli.predict import main as port_main
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        port_main(_argv(setup, tmp_path))


def test_background_iter_consumer_abort():
    """If the consumer aborts mid-iteration, the producer thread ends
    instead of parking on the bounded queue."""
    from unet_tpu_torch.cli.predict import background_iter

    started = threading.Event()
    produced = []

    def gen():
        for i in range(100):
            started.set()
            produced.append(i)
            yield i

    before = threading.active_count()
    with pytest.raises(ValueError):
        for _ in background_iter(gen(), depth=2):
            raise ValueError('downstream failure')
    started.wait(5)
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before
    assert len(produced) <= 10


def test_background_iter_passes_producer_errors_on():
    from unet_tpu_torch.cli.predict import background_iter

    def gen():
        yield 1
        raise KeyError('producer failure')

    with pytest.raises(KeyError):
        list(background_iter(gen()))
