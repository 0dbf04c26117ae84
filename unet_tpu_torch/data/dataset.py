"""Host-side dataset: PNG slice index, volume-based split, batch loader.

Counterpart of ``unet_tpu/data/dataset.py``:

* ``root/{images,labels}/*.png`` named ``{volume}_slice_{idx}.png``;
* the volume split of the reference project: volume ids sorted
  (numerically where they are numbers), shuffled by Python's Mersenne
  Twister seeded with ``seed``, cut at ``int(n*test_ratio)`` and
  ``int(n*val_ratio)`` (the same membership as the JAX package);
* ``SyntheticSliceDataset`` gives the same bytes per ``(seed, name)`` as
  the JAX package's;
* ``BatchLoader`` assembles batches in a thread pool in the same order
  (``np.random.default_rng(seed)`` shuffles each epoch), NCHW: images
  (B, 1, H, W), masks (B, H, W), uint8 on the wire with ``raw_uint8``;
  with ``local_slice`` a rank yields only its rows of each global batch;
* ``prefetch_to_device`` copies the next batches from pinned host memory
  with ``non_blocking`` copies while the current one computes.

The loader's gather and stack (``loader.wait``) and the staging of the
copies (``h2d.stage``) are spans of ``utils/profiling.py``.
"""

from __future__ import annotations

import collections
import random
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from unet_tpu_torch.utils.profiling import H2D_STAGE, LOADER_WAIT, annotate

CLASS_NAMES = ['background', 'tumor']


def volume_split(all_files: List[str], split: str, val_ratio: float = 0.2,
                 test_ratio: float = 0.0, seed: int = 42) -> List[str]:
    """The reference project's volume split (no slice leaks between
    splits)."""
    volume_ids = list({f.split('_slice_')[0] for f in all_files})
    volume_ids.sort(key=lambda x: int(x) if x.isdigit() else x)
    rng = random.Random(seed)
    shuffled = volume_ids.copy()
    rng.shuffle(shuffled)
    n = len(shuffled)
    n_test = int(n * test_ratio)
    n_val = int(n * val_ratio)
    n_train = n - n_test - n_val
    groups = {
        'train': set(shuffled[:n_train]),
        'val': set(shuffled[n_train:n_train + n_val]),
        'test': set(shuffled[n_train + n_val:]),
    }
    split = split.lower()
    if split == 'all':
        return list(all_files)
    if split not in groups:
        raise ValueError(f"Invalid split: {split}. "
                         "Use 'train', 'val', 'test', or 'all'")
    target = groups[split]
    return [f for f in all_files if f.split('_slice_')[0] in target]


class _Slices:
    """Shared sample-info API of the datasets."""

    files: List[str]

    def __len__(self) -> int:
        return len(self.files)

    def get_sample_info(self, idx: int) -> Dict:
        name = self.files[idx]
        parts = name.replace('.png', '').split('_slice_')
        return {'filename': name, 'volume_id': parts[0],
                'slice_id': int(parts[1]) if len(parts) > 1 else 0}

    @property
    def class_names(self) -> List[str]:
        return list(CLASS_NAMES)

    @property
    def num_classes(self) -> int:
        return 2


class SliceDataset(_Slices):
    """PNG slice dataset. ``load`` gives image float32 (H, W) in [0, 1]
    and mask int32 {0, 1} (label > 127), resized on the host to
    ``img_size`` (PIL bilinear for images, NEAREST for masks)."""

    def __init__(self, root: str, split: str = 'train',
                 val_ratio: float = 0.2, test_ratio: float = 0.0,
                 seed: int = 42, img_size: int = 512):
        self.root = Path(root)
        self.split = split.lower()
        self.img_size = img_size
        self.images_dir = self.root / 'images'
        self.labels_dir = self.root / 'labels'
        for d in (self.images_dir, self.labels_dir):
            if not d.exists():
                raise FileNotFoundError(f'Directory not found: {d}')
        all_files = sorted(f.name for f in self.images_dir.glob('*.png'))
        if not all_files:
            raise ValueError(f'No PNG files found in {self.images_dir}')
        self.files = volume_split(all_files, self.split, val_ratio,
                                  test_ratio, seed)
        print(f'SliceDataset [{split}]: {len(self.files)} samples')

    def load_raw(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """image uint8 (H, W), mask uint8 {0, 1}."""
        from PIL import Image
        name = self.files[idx]
        img = Image.open(self.images_dir / name).convert('L')
        msk = Image.open(self.labels_dir / name).convert('L')
        size = (self.img_size, self.img_size)
        if img.size != size:
            img = img.resize(size, Image.BILINEAR)
        if msk.size != size:
            msk = msk.resize(size, Image.NEAREST)
        return (np.asarray(img, np.uint8),
                (np.asarray(msk, np.uint8) > 127).astype(np.uint8))

    def load(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        img, msk = self.load_raw(idx)
        return img.astype(np.float32) / 255.0, msk.astype(np.int32)


class SyntheticSliceDataset(_Slices):
    """Synthetic CT-like slices with blob 'tumors', byte-identical to the
    JAX package's for the same ``(seed, name)``: each slice's generator
    is seeded with ``crc32(f'{seed}:{name}')``."""

    def __init__(self, num_volumes: int = 10, slices_per_volume: int = 8,
                 img_size: int = 512, split: str = 'train',
                 val_ratio: float = 0.2, test_ratio: float = 0.0,
                 seed: int = 42, tumor_prob: float = 0.9,
                 tumor_radius: Tuple[float, float] = (0.02, 0.05)):
        self.img_size = img_size
        self.seed = seed
        self.tumor_prob = tumor_prob
        self.tumor_radius = tumor_radius
        names = [f'{v}_slice_{s:04d}.png' for v in range(num_volumes)
                 for s in range(slices_per_volume)]
        self.files = volume_split(names, split, val_ratio, test_ratio, seed)
        # slices are deterministic per (seed, name): keep the uint8 form
        self._cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

    def load(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        name = self.files[idx]
        rng = np.random.default_rng(zlib.crc32(f'{self.seed}:{name}'.encode()))
        s = self.img_size
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
        img = 0.15 + 0.05 * rng.standard_normal((s, s)).astype(np.float32)
        for cx in (0.32, 0.68):
            d = (((xx / s - cx) / 0.18) ** 2 + ((yy / s - 0.5) / 0.3) ** 2)
            img += 0.35 * np.exp(-d * 3.0)
        mask = np.zeros((s, s), np.int32)
        if rng.random() < self.tumor_prob:
            n_blobs = rng.integers(1, 3)
            for _ in range(n_blobs):
                cx, cy = rng.uniform(0.25, 0.75, 2)
                rad = rng.uniform(*self.tumor_radius) * s
                d2 = (xx - cx * s) ** 2 + (yy - cy * s) ** 2
                blob = d2 < rad ** 2
                mask[blob] = 1
                img[blob] += rng.uniform(0.3, 0.5)
        img = np.clip(img, 0.0, 1.0)
        return img.astype(np.float32), mask

    def load_raw(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        cached = self._cache.get(idx)
        if cached is None:
            img, mask = self.load(idx)
            cached = ((img * 255).astype(np.uint8), mask.astype(np.uint8))
            self._cache[idx] = cached
        return cached


class BatchLoader:
    """Threaded batch assembler. Yields (images (B, 1, H, W), masks
    (B, H, W)) numpy batches: float32 in [0, 1] and int32, or uint8 and
    uint8 with ``raw_uint8``. Train: shuffled each epoch by
    ``np.random.default_rng(seed)``, ``drop_last``. Val: in order, with
    the smaller tail batch.

    ``batch_size`` is always the global batch. With
    ``local_slice=(index, count)`` every rank computes the same global
    order (same seed) and loads and yields only its contiguous
    ``batch_size / count`` rows of each batch. ``pad_tail`` repeats the
    last sample so the tail batch keeps the full shape (``tail_valid``
    says how many of its rows are real)."""

    # batches of decoded samples in flight ahead of the consumer
    max_in_flight = 3

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0,
                 num_threads: int = 8, raw_uint8: bool = False,
                 local_slice: Optional[Tuple[int, int]] = None,
                 pad_tail: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_threads = max(1, num_threads)
        self.raw_uint8 = raw_uint8
        self.pad_tail = pad_tail
        if local_slice is not None:
            _, count = local_slice
            if batch_size % count != 0:
                raise ValueError(f'global batch {batch_size} not divisible '
                                 f'by process count {count}')
            if not (drop_last or pad_tail):
                raise ValueError('local_slice needs drop_last or pad_tail '
                                 '(uneven tail batches cannot be sharded)')
        self.local_slice = local_slice
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def tail_valid(self, batch_index: int) -> int:
        """Number of real (non-pad) rows in the given global batch."""
        return min(self.batch_size,
                   len(self.dataset) - batch_index * self.batch_size)

    def skip_epochs(self, epochs: int) -> None:
        """Draw and discard ``epochs`` epochs' shuffles, so a resumed run
        sees the order an uninterrupted one would."""
        if self.shuffle:
            for _ in range(epochs):
                self._rng.shuffle(np.arange(len(self.dataset)))

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        nb = len(self)
        load = (self.dataset.load_raw if self.raw_uint8
                else self.dataset.load)

        def indices(b: int) -> np.ndarray:
            idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
            if self.pad_tail and len(idxs) < self.batch_size:
                idxs = np.concatenate([
                    idxs, np.repeat(idxs[-1:], self.batch_size - len(idxs))])
            if self.local_slice is not None:
                index, count = self.local_slice
                lb = self.batch_size // count
                idxs = idxs[index * lb:(index + 1) * lb]
            return idxs

        with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
            pending = collections.deque(
                [pool.submit(load, int(i)) for i in indices(b)]
                for b in range(min(self.max_in_flight, nb)))
            next_b = len(pending)
            while pending:
                with annotate(LOADER_WAIT):
                    samples = [f.result() for f in pending.popleft()]
                    if next_b < nb:
                        pending.append([pool.submit(load, int(i))
                                        for i in indices(next_b)])
                        next_b += 1
                    batch = (np.stack([s[0] for s in samples])[:, None],
                             np.stack([s[1] for s in samples]))
                yield batch


def prefetch_to_device(iterator, device, depth: int = 2):
    """Copy each item (a tuple of numpy arrays) to ``device`` ``depth``
    items ahead of the consumer. On CUDA the arrays are pinned and copied
    with ``non_blocking=True``, so the copies overlap the device work
    already queued; on the CPU they are wrapped as they are."""
    device = torch.device(device)
    cuda = device.type == 'cuda'

    def put(item):
        out = []
        with annotate(H2D_STAGE):
            for a in item:
                t = torch.from_numpy(np.ascontiguousarray(a))
                if cuda:
                    t = t.pin_memory().to(device, non_blocking=True)
                out.append(t)
        return tuple(out)

    buf = collections.deque()
    it = iter(iterator)
    for item in it:
        buf.append(put(item))
        if len(buf) >= depth:
            break
    while buf:
        out = buf.popleft()
        for item in it:
            buf.append(put(item))
            break
        yield out


def create_dataloaders(root: str, batch_size: int = 8,
                       val_ratio: float = 0.2, img_size: int = 256,
                       num_workers: int = 8, seed: int = 42,
                       synthetic: bool = False):
    """(train_loader, val_loader): train shuffled with ``drop_last``, val
    in order. Augmentation and normalization run on the device."""
    kwargs = dict(split='train', val_ratio=val_ratio, seed=seed,
                  img_size=img_size)
    if synthetic:
        train_ds = SyntheticSliceDataset(**kwargs)
        val_ds = SyntheticSliceDataset(**{**kwargs, 'split': 'val'})
    else:
        train_ds = SliceDataset(root, **kwargs)
        val_ds = SliceDataset(root, **{**kwargs, 'split': 'val'})
    return (BatchLoader(train_ds, batch_size, shuffle=True, drop_last=True,
                        seed=seed, num_threads=num_workers),
            BatchLoader(val_ds, batch_size, shuffle=False,
                        num_threads=num_workers))
