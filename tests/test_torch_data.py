"""The port's data pipeline (unet_tpu_torch/data/dataset.py) against the
JAX package's: the volume split's membership, the synthetic slices'
bytes, PNG decoding and the batch order must all be identical (exact
contracts: integers and bytes, no tolerance)."""

import numpy as np
import pytest
import torch
from PIL import Image

from unet_tpu.data import dataset as jd
from unet_tpu_torch.data import dataset as td

torch.set_num_threads(2)


@pytest.mark.parametrize('split', ['train', 'val', 'test', 'all'])
@pytest.mark.parametrize('ids', ['numeric', 'named'])
def test_volume_split_membership_identical(split, ids):
    vols = ([str(v) for v in range(23)] if ids == 'numeric'
            else [f'lung_{v}' for v in range(17)])
    files = [f'{v}_slice_{s:04d}.png' for v in vols for s in range(3)]
    for seed in (0, 42, 7):
        for val, test in ((0.2, 0.0), (0.25, 0.1)):
            want = jd.volume_split(files, split, val, test, seed)
            got = td.volume_split(files, split, val, test, seed)
            assert got == want


def test_volume_split_rejects_unknown_split():
    with pytest.raises(ValueError, match='Invalid split'):
        td.volume_split(['1_slice_0000.png'], 'holdout')


@pytest.mark.parametrize('split', ['train', 'val'])
def test_synthetic_slices_byte_identical(split):
    kw = dict(num_volumes=6, slices_per_volume=3, img_size=48, split=split,
              seed=5, tumor_radius=(0.05, 0.12))
    j, t = jd.SyntheticSliceDataset(**kw), td.SyntheticSliceDataset(**kw)
    assert t.files == j.files and len(t) == len(j)
    for i in range(len(t)):
        for a, b in zip(t.load(i), j.load(i)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        for a, b in zip(t.load_raw(i), j.load_raw(i)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert t.get_sample_info(i) == j.get_sample_info(i)
    assert any(t.load_raw(i)[1].any() for i in range(len(t)))


def _png_root(tmp_path, n_vol=5, per=2, size=(40, 30)):
    rng = np.random.default_rng(3)
    for sub in ('images', 'labels'):
        (tmp_path / sub).mkdir()
    for v in range(n_vol):
        for s in range(per):
            name = f'{v}_slice_{s:04d}.png'
            Image.fromarray(rng.integers(0, 256, size[::-1], np.uint8)).save(
                tmp_path / 'images' / name)
            Image.fromarray((rng.random(size[::-1]) > 0.8).astype(np.uint8)
                            * 255).save(tmp_path / 'labels' / name)
    return tmp_path


def test_slice_dataset_decodes_identically(tmp_path):
    root = _png_root(tmp_path)
    for split in ('train', 'val'):
        j = jd.SliceDataset(str(root), split, seed=1, img_size=32)
        t = td.SliceDataset(str(root), split, seed=1, img_size=32)
        assert t.files == j.files
        for i in range(len(t)):
            for a, b in zip(t.load(i), j.load(i)):
                assert a.dtype == b.dtype and np.array_equal(a, b)
            for a, b in zip(t.load_raw(i), j.load_raw(i)):
                assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize('raw', [True, False])
def test_batch_loader_order_identical(raw):
    """Train: shuffled from default_rng(seed) each epoch, drop_last.
    Val: in order, with the smaller tail. NCHW here, NHWC in JAX."""
    kw = dict(num_volumes=8, slices_per_volume=3, img_size=16, seed=3)
    for split, loader_kw in (('train', dict(shuffle=True, drop_last=True,
                                            seed=3)),
                             ('val', dict(shuffle=False))):
        jds = jd.SyntheticSliceDataset(split=split, **kw)
        tds = td.SyntheticSliceDataset(split=split, **kw)
        jl = jd.BatchLoader(jds, 4, num_threads=2, raw_uint8=raw,
                            **loader_kw)
        tl = td.BatchLoader(tds, 4, num_threads=2, raw_uint8=raw,
                            **loader_kw)
        assert len(tl) == len(jl)
        for _ in range(2):  # two epochs: the shuffle advances alike
            jb, tb = list(jl), list(tl)
            assert len(tb) == len(jb) == len(jl)
            for (ji, jm), (ti, tm) in zip(jb, tb):
                assert ti.shape == (ji.shape[0], 1) + ji.shape[1:3]
                assert ti.dtype == ji.dtype and tm.dtype == jm.dtype
                assert np.array_equal(ti[:, 0], ji[..., 0])
                assert np.array_equal(tm, jm)
        if split == 'val':
            assert jb[-1][0].shape[0] == len(tds) % 4 or len(tds) % 4 == 0


def test_prefetch_to_device_on_cpu():
    items = [(np.full((2, 3), i, np.uint8), np.arange(i + 1)) for i in
             range(5)]
    out = list(td.prefetch_to_device(iter(items), 'cpu', depth=2))
    assert len(out) == 5
    for (a, b), (ta, tb) in zip(items, out):
        assert torch.equal(ta, torch.from_numpy(a))
        assert torch.equal(tb, torch.from_numpy(b))


def test_create_dataloaders_synthetic():
    train, val = td.create_dataloaders('', batch_size=4, img_size=16,
                                       num_workers=2, synthetic=True)
    assert train.drop_last and train.shuffle and not val.shuffle
    images, masks = next(iter(train))
    assert images.shape == (4, 1, 16, 16) and masks.shape == (4, 16, 16)
