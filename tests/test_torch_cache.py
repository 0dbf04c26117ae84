"""The port's slice cache (unet_tpu_torch/data/cache.py) against the JAX
package's (unet_tpu/data/cache.py): blobs and sidecars byte-identical
for the native (csrc/libslicecache.so) and the PIL builders, at the
sources' size and resized down and up; CachedSliceDataset with JAX's
files, split and bytes; and the train CLI's --cache building the blob
once, then reusing it, training on the same bytes as the PNG loader.
Every comparison is exact: both packages write and read the same
bytes."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

torch.set_num_threads(2)

SRC = 24  # source PNG size


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    """6 volumes x 2 slices of random 24 px PNGs (tests/test_data.py)."""
    from PIL import Image
    root = tmp_path_factory.mktemp('pngs')
    (root / 'images').mkdir()
    (root / 'labels').mkdir()
    rng = np.random.default_rng(0)
    for n in [f'{v}_slice_{s:04d}.png' for v in range(6) for s in range(2)]:
        Image.fromarray((rng.random((SRC, SRC)) * 255).astype(np.uint8)
                        ).save(root / 'images' / n)
        Image.fromarray(((rng.random((SRC, SRC)) > 0.8) * 255).astype(
            np.uint8)).save(root / 'labels' / n)
    return root


@pytest.fixture(scope='module')
def blobs(root, tmp_path_factory):
    """{(package, native, size): blob path} for both packages."""
    from unet_tpu.data.cache import build_cache as jax_build
    from unet_tpu_torch.data.cache import build_cache
    out = tmp_path_factory.mktemp('blobs')
    paths = {}
    for pkg, build in (('jax', jax_build), ('port', build_cache)):
        for native in (True, False):
            for size in (SRC, 16, 48):
                p = out / f'{pkg}_{native}_{size}.bin'
                build(root, p, img_size=size, prefer_native=native)
                paths[pkg, native, size] = p
    return paths


@pytest.mark.parametrize('size', [SRC, 16, 48])
@pytest.mark.parametrize('native', [True, False])
def test_blob_and_sidecar_equal_jax(blobs, native, size):
    got, want = blobs['port', native, size], blobs['jax', native, size]
    assert got.read_bytes() == want.read_bytes()
    sidecar = Path(str(got) + '.json').read_text()
    assert sidecar == Path(str(want) + '.json').read_text()
    # the native library is built here, so prefer_native takes it
    assert json.loads(sidecar)['native'] is native


@pytest.mark.parametrize('size', [SRC, 16, 48])
def test_native_and_pil_builders_agree(blobs, size):
    assert (blobs['port', True, size].read_bytes()
            == blobs['port', False, size].read_bytes())


@pytest.mark.parametrize('split', ['train', 'val', 'all'])
def test_cached_dataset_matches_jax_and_the_png_loader(blobs, root, split):
    from unet_tpu.data.cache import CachedSliceDataset as JaxCached
    from unet_tpu_torch.data.cache import CachedSliceDataset
    from unet_tpu_torch.data.dataset import SliceDataset
    kw = dict(split=split, val_ratio=0.25, seed=42)
    got = CachedSliceDataset(blobs['port', True, SRC], **kw)
    want = JaxCached(blobs['jax', True, SRC], **kw)
    png = SliceDataset(root, img_size=SRC, **kw)
    assert got.files == want.files == png.files and len(got) > 0
    assert got.img_size == SRC
    for i in range(len(got)):
        for a, b, c in zip(got.load_raw(i), want.load_raw(i),
                           png.load_raw(i)):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
        for a, b in zip(got.load(i), want.load(i)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert got.get_sample_info(i) == want.get_sample_info(i)


def test_load_raw_is_a_view_of_the_map(blobs):
    from unet_tpu_torch.data.cache import CachedSliceDataset
    ds = CachedSliceDataset(blobs['port', True, 16], split='all')
    img, msk = ds.load_raw(0)
    assert isinstance(img, np.memmap) and isinstance(msk, np.memmap)
    assert img.shape == msk.shape == (16, 16)
    assert set(np.unique(msk)) <= {0, 1}


def test_bad_blobs_are_refused(blobs, tmp_path):
    from unet_tpu_torch.data.cache import CachedSliceDataset, build_cache
    src = blobs['port', False, 16]
    bad = tmp_path / 'bad.bin'
    bad.write_bytes(b'XXXX' + src.read_bytes()[4:])
    Path(str(bad) + '.json').write_text(Path(str(src) + '.json').read_text())
    with pytest.raises(ValueError, match='magic'):
        CachedSliceDataset(bad)
    short = tmp_path / 'short.bin'
    short.write_bytes(src.read_bytes())
    meta = json.loads(Path(str(src) + '.json').read_text())
    meta['files'] = meta['files'][:-1]
    Path(str(short) + '.json').write_text(json.dumps(meta))
    with pytest.raises(ValueError, match='mismatch'):
        CachedSliceDataset(short)
    (tmp_path / 'images').mkdir()
    with pytest.raises(ValueError, match='no PNGs'):
        build_cache(tmp_path, tmp_path / 'none.bin')


# ---------------------------------------------------------------- train CLI

def _config(tmp, root, name):
    cfg = {
        'model': {'type': 'unet', 'n_channels': 1, 'n_classes': 2,
                  'bilinear': True, 'base_features': 4,
                  'deep_supervision': False},
        'data': {'root': str(root), 'img_size': 32, 'val_ratio': 0.2,
                 'batch_size': 4, 'num_workers': 2},
        'train': {'epochs': 1, 'lr': 0.001, 'weight_decay': 0.0001,
                  'grad_clip': 1.0, 'accumulation_steps': 2},
        'scheduler': {'type': 'cosine_annealing', 'min_lr': 1e-6},
        'ema': {'enabled': False},
        'early_stopping': {'enabled': False},
        'loss': {'type': 'dice_bce'},
        'augmentation': {'enabled': True},
        'output': {'save_dir': str(tmp / 'runs'), 'experiment_name': name,
                   'save_last': True, 'save_best': True},
        'seed': 42,
        'device': 'cpu',
        'tpu': {'compute_dtype': 'float32'},
    }
    path = tmp / f'{name}.yaml'
    path.write_text(yaml.safe_dump(cfg))
    return path


@pytest.fixture(scope='module')
def cli(tmp_path_factory):
    """A 40 px synthetic dataset as PNGs (resized to 32 on load); the CLI
    without --cache, then twice with it."""
    from PIL import Image
    from unet_tpu_torch.cli import train as port_cli
    from unet_tpu_torch.data.dataset import SyntheticSliceDataset
    tmp = tmp_path_factory.mktemp('cli')
    root = tmp / 'data'
    (root / 'images').mkdir(parents=True)
    (root / 'labels').mkdir()
    ds = SyntheticSliceDataset(num_volumes=8, slices_per_volume=4,
                               img_size=40, split='all',
                               tumor_radius=(0.12, 0.2))
    for i, name in enumerate(ds.files):
        img, msk = ds.load_raw(i)
        Image.fromarray(img).save(root / 'images' / name)
        Image.fromarray(msk * 255).save(root / 'labels' / name)
    blob = tmp / 'slices.bin'
    runs = {'png': port_cli.main(['--config',
                                  str(_config(tmp, root, 'png'))])}
    for name in ('first', 'second'):
        runs[name] = port_cli.main(['--config', str(_config(tmp, root, name)),
                                    '--cache', str(blob)])
        runs[name + '_mtime'] = blob.stat().st_mtime_ns
    return runs, blob


def test_cli_builds_the_cache_once_then_reuses_it(cli):
    runs, blob = cli
    assert blob.exists() and Path(str(blob) + '.json').exists()
    assert json.loads(Path(str(blob) + '.json').read_text())['img_size'] == 32
    assert runs['first_mtime'] == runs['second_mtime']


def test_cli_cache_trains_on_the_png_loaders_bytes(cli):
    runs, _ = cli
    keys = ('train_loss', 'val_loss', 'tumor_dice', 'lr')
    for name in ('first', 'second'):
        assert {k: runs[name][k] for k in keys} == {
            k: runs['png'][k] for k in keys}, name
