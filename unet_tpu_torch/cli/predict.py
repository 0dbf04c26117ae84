#!/usr/bin/env python
"""Directory inference CLI for lung-tumor segmentation on one GPU.

Counterpart of ``unet_tpu/cli/predict.py``, with its flags (``--weights
--source --output --img-size --threshold --device --save-overlay
--no-save-mask --batch-size --decode-workers --no-native-decode
--save-workers``; ``--img-size`` defaults to 256 as in the reference, so
pass 512 for models trained at 512). The model is rebuilt from the
config embedded in a reference-format ``.pt`` checkpoint; a config with
``tpu.fused_attention_gate: true`` runs the eval gates through the
hand-written gate kernel.

The source directory streams through the card in fixed-shape chunks of
``--batch-size`` (the tail padded by repeating its last image): uint8 on
the wire, normalization, softmax and the whole threshold sweep on the
device, and only bit-packed masks read back. Stages overlap: a
background thread decodes chunk i+1 (native threaded libpng through
``csrc/libslicecache.so`` for grayscale PNGs, a PIL pool otherwise, with
identical pixels) while the card computes chunk i; each chunk's packed
masks are copied back asynchronously behind its forward, and the host
unpacks, NEAREST-restores and queues the PNG saves (zlib level 1, on a
save pool) of the older chunk while the newer one computes. A file that
fails to decode is skipped. The exit report gives each stage's wall time
and a steady-state rate that leaves out the first chunk (which pays
cuDNN's autotuning and the kernels' build).

    python -m unet_tpu_torch.cli.predict --weights model.pt \\
        --source slices/ --img-size 512 --threshold 0.3,0.5,0.7

Runs on CUDA unless ``--device cpu`` asks for the CPU.
``--spatial-shard`` (multi-GPU) is not ported yet and stops argument
parsing.
"""

from __future__ import annotations

import argparse
import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from unet_tpu_torch import resolve_device
from unet_tpu_torch.models import create_model
from unet_tpu_torch.utils.torch_port import load_torch_checkpoint

_DTYPES = {'bfloat16': torch.bfloat16, 'float32': torch.float32}


def load_model(weights, dtype=None, device=None):
    """Rebuild the architecture from the checkpoint's config and load its
    weights with a strict state-dict match. Returns ``(model, meta)``
    with the model in eval mode, channels_last, on ``device`` (CUDA
    unless the caller names another).

    The config's ``tpu.compute_dtype`` (default bfloat16) sets the
    compute dtype unless ``dtype`` is given, and ``tpu.fused_attention_gate``
    routes the eval gates through the fused kernel, as the JAX train
    CLI's model does."""
    path = Path(weights)
    if path.is_dir():
        raise ValueError(
            f'{weights} is a directory (an Orbax checkpoint?); the PyTorch '
            'port reads reference-format .pt files only. Convert it with '
            'scripts/export_torch.py --weights DIR --output model.pt')
    dev = resolve_device(device)
    state, cfg, epoch = load_torch_checkpoint(path)
    mcfg = cfg.get('model', {})
    tcfg = cfg.get('tpu', {})
    mtype = mcfg.get('type', 'unet').lower()
    if mtype == 'attention':
        mtype = 'attention_unet'
    if dtype is None:
        dtype = _DTYPES[tcfg.get('compute_dtype', 'bfloat16')]
    model = create_model(
        mtype,
        n_channels=mcfg.get('n_channels', 1),
        n_classes=mcfg.get('n_classes', 2),
        bilinear=mcfg.get('bilinear', True),
        base_features=mcfg.get('base_features', 64),
        deep_supervision=mcfg.get('deep_supervision', False),
        dtype=dtype,
        use_fused_gate=bool(tcfg.get('fused_attention_gate', False)))
    model.load_state_dict(state, strict=True)
    model = model.to(dev, memory_format=torch.channels_last).eval()
    return model, {'config': cfg, 'epoch': epoch}


def preprocess_image(path, img_size):
    """PIL 'L' -> bilinear resize to (img_size, img_size). Returns
    ((1, H, W) uint8, original (W, H)); normalization runs on the device
    (``train.trainer.make_predict_step_u8``)."""
    from PIL import Image
    img = Image.open(path).convert('L')
    orig_size = img.size  # (W, H)
    if img.size != (img_size, img_size):
        img = img.resize((img_size, img_size), Image.BILINEAR)
    return np.asarray(img, np.uint8)[None], orig_size


def restore_mask(mask255, orig_size):
    """NEAREST restore of a {0, 255} mask to the original (W, H)."""
    from PIL import Image
    m = Image.fromarray(mask255)
    if m.size != orig_size:
        m = m.resize(orig_size, Image.NEAREST)
    return np.asarray(m)


def postprocess_mask(prob_tumor, threshold, orig_size):
    """prob > threshold -> uint8 {0,255} -> NEAREST resize to the
    original (W, H)."""
    mask = (np.asarray(prob_tumor) > threshold).astype(np.uint8) * 255
    return restore_mask(mask, orig_size)


class _NotPorted(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f'{option_string} (multi-GPU inference) is not ported '
                     'to unet_tpu_torch yet; the JAX CLI '
                     '(python -m unet_tpu.cli.predict) has it')


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Predict tumor segmentation')
    p.add_argument('--weights', type=str, required=True,
                   help='reference-format .pt checkpoint (e.g. '
                        'runs/exp/weights/best/model.pt)')
    p.add_argument('--source', type=str, required=True,
                   help='image file or directory of png/jpg')
    p.add_argument('--output', type=str, default='predictions')
    p.add_argument('--img-size', type=int, default=256,
                   help='network input size (use the training size!)')
    p.add_argument('--threshold', type=str, default='0.5',
                   help='tumor-probability threshold; a comma list '
                        '(e.g. 0.3,0.5,0.7) sweeps thresholds and saves '
                        'masks for each')
    p.add_argument('--device', type=str, default=None,
                   help='"cpu" runs on the CPU; default CUDA')
    p.add_argument('--spatial-shard', nargs=0, action=_NotPorted,
                   help=argparse.SUPPRESS)
    p.add_argument('--save-overlay', action='store_true')
    p.add_argument('--no-save-mask', action='store_true')
    p.add_argument('--batch-size', type=int, default=8,
                   help='device batch size for directory inference')
    p.add_argument('--decode-workers', type=int, default=4,
                   help='host threads decoding input images')
    p.add_argument('--no-native-decode', action='store_true',
                   help='force the PIL decode path (the native libpng '
                        'stage is bit-exact with PIL for grayscale PNGs '
                        'and used when csrc/libslicecache.so loads)')
    p.add_argument('--save-workers', type=int, default=4,
                   help='host threads encoding and saving output PNGs')
    return p.parse_args(argv)


def create_overlay(image_path, mask, alpha=0.4):
    """Red alpha blend of the predicted mask over the original image."""
    from PIL import Image
    img = np.asarray(Image.open(image_path).convert('RGB'), np.float32)
    m = mask > 127
    img[m] = (1 - alpha) * img[m] + alpha * np.array([255.0, 0.0, 0.0])
    return Image.fromarray(img.astype(np.uint8))


def background_iter(gen, depth: int = 2):
    """Run a generator on a daemon thread behind a bounded queue, so the
    producer (host decode) stays ``depth`` items ahead of the consumer.
    If the consumer stops early (an exception downstream), the producer
    is told to stop instead of blocking forever on the full queue."""
    q = queue.Queue(maxsize=depth)
    done = object()
    stop = threading.Event()

    def put_or_stop(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in gen:
                if not put_or_stop(item):
                    return
            put_or_stop(done)
        except BaseException as e:  # raised in the consumer
            put_or_stop(e)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def gather_sources(source):
    source = Path(source)
    if source.is_file():
        return [source]
    if source.is_dir():
        files = sorted(list(source.glob('*.png')) + list(source.glob('*.jpg')))
        if not files:
            raise ValueError(f'No png/jpg images found in {source}')
        return files
    raise FileNotFoundError(f'Source not found: {source}')


class _Stages:
    """Wall time and bytes per pipeline stage (stages overlap, so each
    is compared with the total, not summed)."""

    NAMES = (('decode', 'host decode+resize'),
             ('h2d_dispatch', 'h2d + dispatch'),
             ('readback_wait', 'device wait+read'),
             ('postprocess', 'unpack+restore'),
             ('save', 'png encode+save'))

    def __init__(self):
        self.seconds = {k: 0.0 for k, _ in self.NAMES}
        self.bytes = {'h2d': 0, 'readback': 0}
        self._lock = threading.Lock()

    def add(self, name, dt):
        with self._lock:
            self.seconds[name] += dt


def main(argv=None):
    """Segment every image of ``--source``; returns a summary dict
    (counts, rates, stage seconds, skipped files, chunks dispatched)."""
    args = parse_args(argv)
    from PIL import Image

    from unet_tpu_torch.data.cache import native_decode_batch
    from unet_tpu_torch.ops.bitpack import unpack_masks_host
    from unet_tpu_torch.train.trainer import make_predict_masks_step

    device = resolve_device(args.device or None)
    model, meta = load_model(args.weights, device=device)
    predict_step = make_predict_masks_step(model)
    print(f"Loaded model from {args.weights} "
          f"(epoch {meta.get('epoch', '?')})")

    files = gather_sources(args.source)
    out_dir = Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    bs = max(1, args.batch_size)
    thresholds = [float(t) for t in str(args.threshold).split(',')]
    thr_dev = torch.tensor(thresholds, dtype=torch.float32, device=device)
    cuda = device.type == 'cuda'

    stages = _Stages()
    skipped, coverages = [], []
    n_with_tumor = 0
    use_native = not args.no_native_decode

    def try_decode(f):
        try:
            x, orig = preprocess_image(f, args.img_size)
            return x[0], orig
        except Exception as e:  # per-image skip
            print(f'  skip {f.name}: {e}')
            skipped.append(f)
            return None

    def decode_chunk(chunk, pool):
        """Per file ((S, S) uint8, (W, H)) or None (skipped): grayscale
        PNGs through the native stage, everything it refuses (color,
        16-bit, corrupt, JPEG) through the PIL pool."""
        nonlocal use_native
        results = [None] * len(chunk)
        pil_idx = list(range(len(chunk)))
        png_idx = [i for i, f in enumerate(chunk)
                   if f.suffix.lower() == '.png']
        if use_native and png_idx:
            dec = native_decode_batch(
                [chunk[i] for i in png_idx], args.img_size,
                num_threads=max(1, args.decode_workers))
            if dec is None:  # library unavailable: stop asking
                use_native = False
            else:
                out, meta_wh = dec
                pil_idx = [i for i in range(len(chunk)) if i not in png_idx]
                for j, i in enumerate(png_idx):
                    w, h = int(meta_wh[j, 0]), int(meta_wh[j, 1])
                    if w >= 0:
                        results[i] = (out[j], (w, h))
                    else:
                        pil_idx.append(i)
        for i, dec in zip(sorted(pil_idx), pool.map(
                try_decode, [chunk[i] for i in sorted(pil_idx)])):
            results[i] = dec
        return results

    def decoded_chunks(pool):
        for start in range(0, len(files), bs):
            chunk = files[start:start + bs]
            t0 = time.perf_counter()
            decoded = decode_chunk(chunk, pool)
            stages.add('decode', time.perf_counter() - t0)
            batch = [d[0] for d in decoded if d is not None]
            metas = [(f, d[1]) for f, d in zip(chunk, decoded)
                     if d is not None]
            if not batch:
                continue
            n_real = len(batch)
            batch += [batch[-1]] * (bs - n_real)  # the fixed batch shape
            yield np.stack(batch)[:, None], metas, n_real

    def save_png(make_image, path):
        """Build the image and encode it (on the save pool); zlib level 1
        is lossless and several times faster than PIL's default 6."""
        t0 = time.perf_counter()
        make_image().save(path, compress_level=1)
        stages.add('save', time.perf_counter() - t0)

    def postprocess(packed, metas, n_real, save_pool, pending):
        nonlocal n_with_tumor
        for i in range(n_real):
            f, orig = metas[i]
            masks = [restore_mask(unpack_masks_host(packed[t, i],
                                                    args.img_size)
                                  * np.uint8(255), orig)
                     for t in range(len(thresholds))]
            mask = masks[0]
            if not args.no_save_mask:
                names = [f'{f.stem}_mask.png'] + [
                    f'{f.stem}_mask_t{thr:g}.png' for thr in thresholds[1:]]
                for name, m in zip(names, masks):
                    pending.append(save_pool.submit(
                        save_png, lambda m=m: Image.fromarray(m),
                        out_dir / name))
            if args.save_overlay:
                pending.append(save_pool.submit(
                    save_png, lambda f=f, mask=mask: create_overlay(f, mask),
                    out_dir / f'{f.stem}_overlay.png'))
            tumor_px = int((mask > 127).sum())
            n_with_tumor += tumor_px > 0
            coverages.append(tumor_px / mask.size)
            print(f'  {f.name}: tumor coverage '
                  f'{100.0 * tumor_px / mask.size:.2f}%')

    # one chunk computes on the card while the host finishes the older
    # one: each chunk's packed masks are copied back (pinned, async)
    # right behind its forward, and an event marks when they are there
    inflight = deque()
    pending = []
    chunks = 0
    first = None  # (slices, time the first chunk's masks were back)
    t_drive = time.perf_counter()

    def drain_one(save_pool):
        nonlocal first
        host, ready, metas, n_real = inflight.popleft()
        t0 = time.perf_counter()
        if ready is not None:
            ready.synchronize()
        stages.add('readback_wait', time.perf_counter() - t0)
        arr = host.numpy()
        stages.bytes['readback'] += arr.nbytes
        t0 = time.perf_counter()
        postprocess(arr, metas, n_real, save_pool, pending)
        stages.add('postprocess', time.perf_counter() - t0)
        if first is None:
            first = (n_real, time.perf_counter())

    with ThreadPoolExecutor(max(1, args.decode_workers)) as decode_pool, \
            ThreadPoolExecutor(max(1, args.save_workers)) as save_pool:
        for batch, metas, n_real in background_iter(
                decoded_chunks(decode_pool)):
            t0 = time.perf_counter()
            u8 = torch.from_numpy(batch)
            if cuda:
                u8 = u8.pin_memory().to(device, non_blocking=True)
            stages.bytes['h2d'] += batch.nbytes
            packed = predict_step(u8, thr_dev)
            chunks += 1
            if cuda:
                host = torch.empty(packed.shape, dtype=packed.dtype,
                                   pin_memory=True)
                host.copy_(packed, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record()
            else:
                host, ready = packed, None
            stages.add('h2d_dispatch', time.perf_counter() - t0)
            inflight.append((host, ready, metas, n_real))
            if len(inflight) > 1:
                drain_one(save_pool)
        while inflight:
            drain_one(save_pool)
        for fut in pending:  # surface any save failure
            fut.result()
    drive_dt = time.perf_counter() - t_drive

    n_done = len(coverages)
    summary = {'processed': n_done, 'files': len(files),
               'skipped': [str(f) for f in skipped], 'chunks': chunks,
               'seconds': drive_dt, 'stage_seconds': dict(stages.seconds),
               'slices_per_s': n_done / max(drive_dt, 1e-9),
               'steady_slices_per_s': None}
    print(f'\nProcessed {n_done}/{len(files)} images ({len(skipped)} '
          f'failed) in {drive_dt:.1f}s ({summary["slices_per_s"]:.1f} '
          f'slices/s end-to-end, first chunk included)')
    if n_done:
        if first is not None and n_done > first[0]:
            rest = time.perf_counter() - first[1]
            summary['steady_slices_per_s'] = (n_done - first[0]) / max(
                rest, 1e-9)
            print(f'Steady state after the first chunk: '
                  f'{summary["steady_slices_per_s"]:.1f} slices/s '
                  f'({n_done - first[0]} slices in {rest:.2f}s)')
        per = 1000.0 / n_done
        print('Stage wall time (stages overlap; each vs the '
              f'{drive_dt:.1f}s total shows what binds):')
        for name, label in _Stages.NAMES:
            s = stages.seconds[name]
            print(f'  {label:<18} {s:8.2f}s  ({s * per:6.2f} ms/slice)')
        print(f'  wire: {stages.bytes["h2d"] / 1e6:.1f} MB up '
              f'({stages.bytes["h2d"] / 1e3 / n_done:.0f} KB/slice), '
              f'{stages.bytes["readback"] / 1e6:.2f} MB down (bit-packed)')
        print(f'Images with tumor: {n_with_tumor} '
              f'({100.0 * n_with_tumor / n_done:.1f}%)')
        print(f'Average tumor coverage: '
              f'{100.0 * float(np.mean(coverages)):.2f}%')
    print(f'Results saved to: {out_dir}')
    return summary


if __name__ == '__main__':
    main()
