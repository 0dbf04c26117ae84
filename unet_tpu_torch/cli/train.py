#!/usr/bin/env python
"""Train UNet / Attention U-Net / TransUNet for lung-tumor segmentation
on one GPU.

Counterpart of ``unet_tpu/cli/train.py``, with its flags and epoch loop:

  * microbatches of ``data.batch_size`` grouped into super-batches of
    ``train.accumulation_steps`` (a shorter last one is padded and its
    padding masked out: the leftover flush);
  * each super-batch is augmented on the device in one call (the fused
    warp kernel for C == 1), from a generator seeded by (seed + 1, step);
  * one optimizer step per super-batch: grads summed over the real
    microbatches, global-norm clip, AdamW, optional EMA;
  * validation on the device's confusion matrix, the EMA warmup state
    machine, ``last``/``best`` checkpoints in the reference ``.pt``
    payload, scheduler stepping, early stopping and ``history.json``;
  * ``--resume PATH`` (a ``weights/last`` or ``weights/best`` directory)
    restores the weights, AdamW state, step counter, epoch, plateau
    scheduler, EMA shadow and the best-metric tracker, and replays the
    loader's shuffles and the augmentation step, so the resumed epochs
    see the data an uninterrupted run would; ``--resume auto`` continues
    the newest run of the experiment in its own directory, or starts
    fresh when there is none;
  * ``--profile-dir DIR`` writes a ``torch.profiler`` Chrome trace of the
    first epoch's training into DIR, holding the program's spans
    (``utils/profiling.py``: ``train.fetch`` with its ``loader.wait`` and
    ``h2d.stage``, ``train.augment``, ``train.step`` with its
    ``step.update``) beside the ops and kernels;
  * at the end, ``training_curves.png`` and ``val_predictions.png``
    (the best weights on up to 8 validation slices with tumor), or one
    line saying the plots were skipped where matplotlib is missing;
  * ``--cache PATH`` (or ``data.cache``) streams the slices from a
    memory-mapped slice cache, built from ``data.root`` at ``img_size``
    when the blob does not exist yet;
  * data parallel over several ranks (``core/mesh.py``): ``--coordinator
    HOST:PORT --num-processes N --process-id I`` joins N processes, and
    ``tpu.data_parallel`` ranks per process (-1: one per local GPU) are
    spawned by this command. Every rank loads its rows of each global
    batch; BatchNorm statistics, gradients and validation counts are the
    global batch's; rank 0 alone writes logs, the run directory,
    checkpoints, ``history.json`` and plots, and decides ``--resume
    auto``.

Runs on CUDA unless ``--device cpu`` (or ``device: cpu`` in the config)
asks for the CPU; where CUDA is asked for and absent it raises.

    python -m unet_tpu_torch.cli.train --config configs/lung_tumor.yaml \\
        --synthetic --epochs 2
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# the interpreter's thread switch interval while a rank trains
LOOP_SWITCH_INTERVAL_S = 5e-4


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Train lung tumor segmentation')
    p.add_argument('--config', type=str, default='configs/lung_tumor.yaml')
    p.add_argument('--data', type=str, default=None,
                   help='dataset root (overrides config)')
    p.add_argument('--img-size', type=int, default=None)
    p.add_argument('--batch-size', type=int, default=None)
    p.add_argument('--workers', type=int, default=None)
    p.add_argument('--epochs', type=int, default=None)
    p.add_argument('--lr', type=float, default=None)
    p.add_argument('--resume', type=str, default=None,
                   help='checkpoint dir to resume (e.g. runs/exp/weights/'
                        'last), or "auto" for the newest run of this '
                        'experiment')
    p.add_argument('--init-weights', type=str, default=None,
                   help='initialize the model from a reference-format .pt '
                        '(optimizer, scheduler and epoch start fresh)')
    p.add_argument('--name', type=str, default=None)
    p.add_argument('--project', type=str, default=None)
    p.add_argument('--device', type=str, default=None,
                   help='"cpu" runs on the CPU; default CUDA')
    p.add_argument('--synthetic', action='store_true',
                   help='use a synthetic dataset (no files needed)')
    p.add_argument('--synthetic-volumes', type=int, default=12,
                   help='synthetic dataset: number of volumes')
    p.add_argument('--synthetic-slices', type=int, default=4,
                   help='synthetic dataset: slices per volume')
    p.add_argument('--synthetic-tumor-radius', type=str, default=None,
                   metavar='MIN,MAX',
                   help='synthetic dataset: tumor radius range as a '
                        'fraction of img_size (default 0.02,0.05)')
    p.add_argument('--profile-dir', type=str, default=None,
                   help='write a torch.profiler trace of the first epoch, '
                        'with the program\'s spans, here')
    p.add_argument('--debug-nans', action='store_true',
                   help='fail on the first non-finite loss (reads each '
                        'super-batch loss back, which syncs)')
    p.add_argument('--cache', type=str, default=None,
                   help='slice-cache blob path: built (natively where '
                        'the library loads) if missing, then memory-mapped')
    p.add_argument('--coordinator', type=str, default=None,
                   help='multi-process: rank 0\'s host:port')
    p.add_argument('--num-processes', type=int, default=None,
                   help='multi-process: total process count')
    p.add_argument('--process-id', type=int, default=None,
                   help='multi-process: this process index')
    args = p.parse_args(argv)
    if args.num_processes and args.num_processes > 1 and (
            not args.coordinator or args.process_id is None):
        p.error('--num-processes above 1 needs --coordinator and '
                '--process-id')
    return args


def apply_overrides(config, args):
    """CLI-over-YAML override merge."""
    if args.data:
        config['data']['root'] = args.data
    if args.img_size:
        config['data']['img_size'] = args.img_size
    if args.batch_size:
        config['data']['batch_size'] = args.batch_size
    if args.workers:
        config['data']['num_workers'] = args.workers
    if args.epochs:
        config['train']['epochs'] = args.epochs
    if args.lr:
        config['train']['lr'] = args.lr
    if args.name:
        config['output']['experiment_name'] = args.name
    if args.project:
        config['output']['save_dir'] = args.project
    if args.device:
        config['device'] = args.device
    return config


def main(argv=None):
    """Run the training; returns the epoch history (the dict written to
    ``history.json``) with the run directory under ``'save_dir'``, each
    epoch's train wall time under ``'train_seconds'`` and each rank's
    kernel launches over the run under ``'kernel_launches'`` (library
    name -> one count per rank, as ``ops._build.launches`` keys them).
    Where this host runs several ranks, they run in spawned processes and
    local rank 0's result is returned."""
    args = parse_args(argv)

    from unet_tpu_torch import resolve_device
    from unet_tpu_torch.core.mesh import free_port, local_degree
    from unet_tpu_torch.utils.config import load_config

    config = apply_overrides(load_config(args.config), args)
    device = resolve_device(str(config.get('device') or '') or None)
    degree = local_degree(config.get('tpu', {}).get('data_parallel', -1),
                          device)
    if degree == 1:
        return _rank_main(0, args, config, device.type, 1, args.coordinator)
    coordinator = (args.coordinator if (args.num_processes or 1) > 1
                   else f'127.0.0.1:{free_port()}')
    with tempfile.TemporaryDirectory() as tmp:
        result = Path(tmp) / 'result.json'
        # raises when a rank fails, after stopping the others
        torch.multiprocessing.spawn(
            _rank_main, (args, config, device.type, degree, coordinator,
                         str(result)), nprocs=degree)
        return json.loads(result.read_text())


def _rank_main(local_index, args, config, device_type, degree,
               coordinator, result_path=None):
    """One rank: join the process group where there are several ranks,
    train, leave the group; local rank 0 writes its result as JSON to
    ``result_path`` where one is given."""
    import torch.distributed as dist

    from unet_tpu_torch.core.distributed import init_distributed
    from unet_tpu_torch.core.mesh import global_rank, rank_device

    world = (args.num_processes or 1) * degree
    rank = global_rank(args.process_id or 0, degree, local_index)
    device = rank_device(device_type, local_index)
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    init_distributed(coordinator, world, rank, device)
    # the loop thread dispatches the step's ops, and each op drops the
    # GIL; taking it back from a loader thread can wait a whole switch
    # interval (5 ms by default), which made the host-bound step's pace
    # erratic
    interval = sys.getswitchinterval()
    sys.setswitchinterval(LOOP_SWITCH_INTERVAL_S)
    try:
        result = _train(args, config, device, rank, world)
    finally:
        sys.setswitchinterval(interval)
        if dist.is_initialized():
            dist.destroy_process_group()
    if result_path and local_index == 0:
        Path(result_path).write_text(json.dumps(result))
    return result


def _train(args, config, device, rank, world):
    from unet_tpu_torch.core.distributed import (all_reduce_sum_, barrier,
                                                 broadcast_from_main,
                                                 gather_objects)
    from unet_tpu_torch.core.mesh import check_global_batch, replicate
    from unet_tpu_torch.data.augmentations import (AugmentConfig,
                                                   augment_batch_seeded,
                                                   normalize_batch)
    from unet_tpu_torch.data.cache import CachedSliceDataset, build_cache
    from unet_tpu_torch.data.dataset import (BatchLoader, SliceDataset,
                                             SyntheticSliceDataset,
                                             prefetch_to_device)
    from unet_tpu_torch.models import create_model_from_config
    from unet_tpu_torch.ops._build import launches
    from unet_tpu_torch.train.callbacks import (CheckpointManager,
                                                EarlyStopping)
    from unet_tpu_torch.train.losses import create_loss_function
    from unet_tpu_torch.train.metrics import SegmentationMetrics
    from unet_tpu_torch.train.schedules import create_scheduler
    from unet_tpu_torch.train.trainer import (EmaState, create_optimizer,
                                              ema_reinit, make_eval_step,
                                              make_train_step,
                                              validation_loss)
    from unet_tpu_torch.utils.config import (compute_dtype,
                                             describe_devices,
                                             get_nested_metric,
                                             increment_path, set_seed,
                                             validate_config)
    from unet_tpu_torch.utils import plots
    from unet_tpu_torch.utils.profiling import (TRAIN_AUGMENT, TRAIN_FETCH,
                                                TRAIN_STEP, annotate,
                                                nan_guard, trace)
    from unet_tpu_torch.utils.torch_port import load_torch_checkpoint

    is_main = rank == 0
    launches_before = dict(launches)
    log = print if is_main else (lambda *a, **k: None)
    validate_config(config)
    seed = config.get('seed', 42)
    set_seed(seed)
    log(f'Using device: {describe_devices(device)}')
    if world > 1:
        import torch.distributed as dist
        log(f'Data parallel: {world} ranks, {dist.get_backend()} backend')

    guard = nan_guard(args.debug_nans)

    # ---- resume target: resolved before the run directory, since
    # `--resume auto` continues inside the newest existing run. Only rank
    # 0 reads its filesystem; the decision is broadcast ----
    resume_path = args.resume
    auto_run_dir = None
    if resume_path == 'auto':
        found = (CheckpointManager.find_auto_resume(
            config['output']['save_dir'],
            config['output']['experiment_name']) if is_main else None)
        found = broadcast_from_main(found)
        if found is None:
            log('--resume auto: no previous checkpoint found, starting '
                'fresh')
            resume_path = None
        else:
            resume_path = str(found)
            auto_run_dir = found.parent.parent
            log(f'--resume auto: continuing {auto_run_dir}')
    if resume_path and Path(resume_path).is_file():  # .../model.pt
        resume_path = str(Path(resume_path).parent)

    # ---- run directory: rank 0 owns every file the run writes ----
    save_dir = None
    if is_main:
        save_dir = auto_run_dir or increment_path(
            Path(config['output']['save_dir'])
            / config['output']['experiment_name'])
        (save_dir / 'weights').mkdir(parents=True, exist_ok=True)
    save_dir = Path(broadcast_from_main(str(save_dir) if is_main else None))
    weights_dir = save_dir / 'weights'
    log(f'Results will be saved to: {save_dir}')

    # ---- data ----
    data_cfg = config['data']
    img_size = data_cfg['img_size']
    batch_size = data_cfg['batch_size']
    check_global_batch(batch_size, world)
    split_kw = dict(val_ratio=data_cfg.get('val_ratio', 0.2), seed=seed)
    cache_path = args.cache or data_cfg.get('cache')
    if args.synthetic:
        ds_kwargs = dict(num_volumes=args.synthetic_volumes,
                         slices_per_volume=args.synthetic_slices,
                         img_size=img_size, **split_kw)
        if args.synthetic_tumor_radius:
            lo, hi = (float(v) for v in
                      args.synthetic_tumor_radius.split(','))
            ds_kwargs['tumor_radius'] = (lo, hi)
        train_ds = SyntheticSliceDataset(split='train', **ds_kwargs)
        val_ds = SyntheticSliceDataset(split='val', **ds_kwargs)
    elif cache_path:
        if is_main and not Path(cache_path).exists():
            log(f'Building slice cache at {cache_path} ...')
            build_cache(data_cfg['root'], cache_path, img_size=img_size)
        barrier()  # the other ranks wait for rank 0's blob
        train_ds = CachedSliceDataset(cache_path, 'train', **split_kw)
        val_ds = CachedSliceDataset(cache_path, 'val', **split_kw)
    else:
        train_ds = SliceDataset(data_cfg['root'], 'train',
                                img_size=img_size, **split_kw)
        val_ds = SliceDataset(data_cfg['root'], 'val', img_size=img_size,
                              **split_kw)
    workers = data_cfg.get('num_workers', 8)
    # every rank computes the same global order and loads its rows of
    # each batch; validation tails are padded to the full batch and the
    # pad rows masked in the eval step
    local = (rank, world) if world > 1 else None
    train_loader = BatchLoader(train_ds, batch_size, shuffle=True,
                               drop_last=True, seed=seed,
                               num_threads=workers, raw_uint8=True,
                               local_slice=local)
    val_loader = BatchLoader(val_ds, batch_size, shuffle=False,
                             num_threads=workers, raw_uint8=True,
                             local_slice=local, pad_tail=world > 1)
    log(f'Train samples: {len(train_ds)}, Val samples: {len(val_ds)}')

    aug_yaml = config.get('augmentation', {})
    augment_enabled = aug_yaml.get('enabled', True)
    aug_cfg = AugmentConfig.from_yaml(aug_yaml)

    # ---- model ----
    model_cfg = config['model']
    tpu_cfg = config.get('tpu', {})
    dtype = compute_dtype(tpu_cfg)
    deep_supervision = model_cfg.get('deep_supervision', False)
    model = create_model_from_config(
        {'img_size': img_size, **model_cfg}, dtype, tpu_cfg,
        generator=torch.Generator().manual_seed(seed))
    if args.init_weights:
        log(f'Initializing weights from {args.init_weights}')
        state, _, _ = load_torch_checkpoint(args.init_weights)
        model.load_state_dict(state, strict=True)
    model = replicate(model.to(device, memory_format=torch.channels_last))
    n_classes = model_cfg['n_classes']
    log(f'Model parameters: {model.get_num_params():,}')

    ema_cfg = config.get('ema', {})
    use_ema = ema_cfg.get('enabled', True)
    ema_decay = ema_cfg.get('decay', 0.99)
    ema_warmup_epochs = ema_cfg.get('warmup_epochs', 5) if use_ema else 0
    ema = ema_reinit(model) if use_ema else None
    if use_ema:
        log(f'Using EMA with decay={ema_decay}, '
            f'warmup={ema_warmup_epochs} epochs')

    loss_cfg = config['loss']
    loss_fn = create_loss_function(
        loss_type=loss_cfg['type'],
        ce_weight=loss_cfg.get('ce_weight', 1.0),
        dice_weight=loss_cfg.get('dice_weight', 1.0),
        class_weights=loss_cfg.get('class_weights'),
        balanced_class_weight=loss_cfg.get('balanced_class_weight', 0.5),
        deep_supervision=deep_supervision)
    log(f"Loss function: {loss_cfg['type']}"
        + (' + Deep Supervision' if deep_supervision else ''))

    train_cfg = config['train']
    base_lr = train_cfg['lr']
    opt = create_optimizer(model, base_lr,
                           weight_decay=train_cfg.get('weight_decay', 1e-4))
    accum = train_cfg.get('accumulation_steps', 1)
    if accum > 1:
        log(f'Gradient accumulation: {accum} steps '
            f'(effective batch={batch_size * accum})')
    train_step = make_train_step(model, loss_fn, opt, accum_steps=accum,
                                 ema_decay=ema_decay, use_ema=use_ema,
                                 grad_clip=train_cfg.get('grad_clip', 0.0))
    weighted = world > 1
    eval_step = make_eval_step(model, loss_fn, n_classes,
                               with_weights=weighted)
    # the EMA weights are validated in a shadow copy of the model
    shadow = copy.deepcopy(model) if use_ema else None
    eval_shadow = (make_eval_step(shadow, loss_fn, n_classes,
                                  with_weights=weighted)
                   if use_ema else None)

    # ---- scheduler / callbacks ----
    epochs = train_cfg['epochs']
    sched_kind, scheduler = create_scheduler(config.get('scheduler', {}),
                                             base_lr, epochs)
    es_cfg = config.get('early_stopping', {})
    early_stopping = (EarlyStopping(patience=es_cfg.get('patience', 20),
                                    mode=es_cfg.get('mode', 'max'))
                      if es_cfg.get('enabled', True) else None)
    monitor = es_cfg.get('monitor', 'class_dice.tumor')
    checkpoint = CheckpointManager(
        weights_dir, monitor=monitor, mode=es_cfg.get('mode', 'max'),
        save_last=config['output'].get('save_last', True),
        save_best=config['output'].get('save_best', True)) if is_main \
        else None
    metrics = SegmentationMetrics(n_classes, ['background', 'tumor'])
    log(f'Monitoring metric: {monitor}')

    # ---- resume: rank 0 reads the checkpoint and broadcasts it ----
    start_epoch = 0
    aug_step = 0
    if resume_path:
        log(f'Resuming from {resume_path}')
        ckpt = broadcast_from_main(
            CheckpointManager.load(resume_path) if is_main else None)
        meta, ts = ckpt['meta'], ckpt['train_state']
        model.load_state_dict(ts['model_state_dict'], strict=True)
        opt.load_state_dict(ckpt['payload']['optimizer_state_dict'])
        if use_ema and ts.get('ema') is not None:
            e = ts['ema']
            ema = EmaState(
                params={k: v.to(device) for k, v in e['params'].items()},
                buffers={k: v.to(device) for k, v in e['buffers'].items()},
                updates=int(e['updates']))
        train_step.steps = int(meta.get('step') or 0)
        if meta.get('scheduler') and sched_kind == 'plateau':
            scheduler.load_state_dict(meta['scheduler'])
        start_epoch = int(meta.get('epoch', -1)) + 1
        aug_step = int(ts.get('aug_step', 0))
        train_loader.skip_epochs(start_epoch)
        log(f'Resumed from epoch {start_epoch} (optimizer step '
            f'{train_step.steps})')
        # seed the best-tracker from the run's best checkpoint, so a
        # post-resume epoch cannot demote a better pre-resume 'best'
        best_dir = Path(resume_path).parent / 'best'
        if checkpoint is not None and (best_dir / 'meta.json').exists():
            prev = CheckpointManager.read_meta(best_dir)
            if prev.get('monitor_value') is not None:
                checkpoint.best_value = prev['monitor_value']
                checkpoint.best_epoch = prev.get('epoch', -1)

    history = {k: [] for k in ('train_loss', 'val_loss', 'val_dice',
                               'val_iou', 'val_accuracy', 'tumor_dice',
                               'lr')}
    train_seconds = []
    local_batch = batch_size // world

    def run_validation(step_fn):
        """Metrics of the global validation set on every rank: each rank
        sums its confusion matrices and keeps its loss of each batch
        (its share of the global batch's loss); both are summed over the
        ranks once, at the end."""
        metrics.reset()
        losses, cm_sum = [], None
        for b, (images, masks) in enumerate(
                prefetch_to_device(val_loader, device)):
            images = normalize_batch(images.float() / 255.0)
            if weighted:
                real = min(max(val_loader.tail_valid(b) - rank * local_batch,
                               0), local_batch)
                w = torch.zeros(local_batch, device=device)
                w[:real] = 1.0
                loss, cm = step_fn(images, masks, w)
            else:
                loss, cm = step_fn(images, masks)
            losses.append(loss)
            cm_sum = cm if cm_sum is None else cm_sum + cm
        if cm_sum is not None:
            metrics.update_from_matrix(all_reduce_sum_(cm_sum))
        results = metrics.compute()
        results['loss'] = validation_loss(losses)
        return results

    def superbatches():
        """``accum`` microbatches stacked into one uint8 payload, with
        the (A,) mask of real microbatches; a short last group is padded
        by repeating its last microbatch (the leftover flush)."""
        pending = []

        def emit(batches):
            mb = np.zeros((accum,), np.float32)
            mb[:len(batches)] = 1.0
            batches = batches + [batches[-1]] * (accum - len(batches))
            return (np.stack([b[0] for b in batches]),
                    np.stack([b[1] for b in batches]), mb)

        for images, masks in train_loader:
            pending.append((images, masks))
            if len(pending) == accum:
                yield emit(pending)
                pending = []
        if pending:
            yield emit(pending)

    log('\nStarting training...')
    log('=' * 60)
    for epoch in range(start_epoch, epochs):
        lr = scheduler(epoch) if sched_kind == 'epoch' else scheduler.lr
        log(f'\nEpoch {epoch + 1}/{epochs} (lr={lr:.2e})')
        t0 = time.time()
        profiling = (bool(args.profile_dir) and epoch == start_epoch
                     and is_main)
        with trace(args.profile_dir if profiling else None):
            loss_sums, n_micro = [], 0
            mb_queue = []

            def device_stream():
                for imgs, msks, mb in superbatches():
                    mb_queue.append(mb)
                    yield imgs, msks

            stream = prefetch_to_device(device_stream(), device)
            # one fetch per optimizer step: fetching the last super-batch
            # already finds the loader's end
            for _ in range(-(-len(train_loader) // accum)):
                with annotate(TRAIN_FETCH):
                    imgs, msks = next(stream)
                mb = mb_queue.pop(0)
                n_micro += int(mb.sum())
                a, b = imgs.shape[:2]
                with annotate(TRAIN_AUGMENT, device):
                    imgs = imgs.float() / 255.0
                    if augment_enabled:
                        flat_i, flat_m = augment_batch_seeded(
                            imgs.reshape(a * b, *imgs.shape[2:]),
                            msks.reshape(a * b, *msks.shape[2:]), seed + 1,
                            aug_step, aug_cfg, local_slice=local, groups=a)
                        aug_step += 1
                        imgs = flat_i.reshape(imgs.shape)
                        msks = flat_m.reshape(msks.shape)
                    else:
                        imgs = normalize_batch(imgs)
                with annotate(TRAIN_STEP):
                    loss_sum = train_step(imgs, msks, lr, mb, ema)
                guard.check_finite(loss_sum, f'loss at epoch {epoch + 1}, '
                                   f'optimizer step {train_step.steps}')
                loss_sums.append(loss_sum)
            train_loss = (sum(torch.stack(loss_sums).tolist()) if loss_sums
                          else 0.0) / max(n_micro, 1)
            train_dt = time.time() - t0  # tolist() waited for the steps
            train_seconds.append(train_dt)
        if profiling:
            log(f'  profiler trace of epoch {epoch + 1} written to '
                f'{args.profile_dir}')

        # ---- EMA warmup state machine ----
        use_ema_for_val = use_ema and epoch >= ema_warmup_epochs
        if use_ema and epoch == ema_warmup_epochs:
            ema = ema_reinit(model)
            log(f'  EMA re-initialized from training model at epoch '
                f'{epoch + 1}')
        if use_ema_for_val:
            shadow.load_state_dict(ema.state_dict())
            val_state, val_model_name = shadow.state_dict(), 'EMA model'
            val_results = run_validation(eval_shadow)
        else:
            val_state = model.state_dict()
            val_model_name = ('training model (EMA warmup)' if use_ema
                              else 'training model')
            val_results = run_validation(eval_step)
        dt = time.time() - t0

        history['train_loss'].append(train_loss)
        history['val_loss'].append(val_results['loss'])
        history['val_dice'].append(val_results['mean_dice'])
        history['val_iou'].append(val_results['mean_iou'])
        history['val_accuracy'].append(val_results['pixel_accuracy'])
        history['tumor_dice'].append(
            val_results['class_dice'].get('tumor', 0.0))
        history['lr'].append(lr)

        log(f'  Train Loss: {train_loss:.4f}  ({train_dt:.1f}s, '
            f'{len(train_ds) / max(train_dt, 1e-9):.1f} slices/s; '
            f'val {dt - train_dt:.1f}s)')
        log(f"  Val [{val_model_name}]: Loss={val_results['loss']:.4f} | "
            f"Dice={val_results['mean_dice']:.4f} | "
            f"IoU={val_results['mean_iou']:.4f} | "
            f"Acc={val_results['pixel_accuracy']:.4f}")
        log(f"  Tumor Dice: {val_results['class_dice'].get('tumor', 0):.4f}"
            f" | Tumor IoU: {val_results['class_iou'].get('tumor', 0):.4f}")

        # every rank holds the same global metrics, so every rank takes
        # the same scheduler and early-stopping decisions
        monitored = get_nested_metric(val_results, monitor)
        if sched_kind == 'plateau':
            scheduler.step(monitored)

        if checkpoint is not None:
            # the plateau state after this epoch's step: the one the next
            # epoch reads, so a resumed run steps as an uninterrupted one
            sched_state = (scheduler.state_dict() if sched_kind == 'plateau'
                           else None)
            ema_state = (None if ema is None else
                         {'params': ema.params, 'buffers': ema.buffers,
                          'updates': ema.updates})
            checkpoint.save(val_state, opt.state_dict(), epoch, val_results,
                            config=config, scheduler_state=sched_state,
                            step=train_step.steps,
                            train_state={
                                'model_state_dict': model.state_dict(),
                                'ema': ema_state, 'aug_step': aug_step})

        if early_stopping and early_stopping(monitored):
            log('\nEarly stopping triggered!')
            break

    log('\n' + '=' * 60)
    log('Training complete!')
    # each library's kernel launches on each rank over the run (0 where
    # a CPU run or the model took the plain versions)
    per_rank = gather_objects({k: n - launches_before[k]
                               for k, n in launches.items()})
    kernel_launches = {k: [r[k] for r in per_rank] for k in per_rank[0]}
    log(f'Kernel launches per rank: {json.dumps(kernel_launches)}')
    result = {**history, 'save_dir': str(save_dir),
              'train_seconds': train_seconds,
              'kernel_launches': kernel_launches}
    if not is_main:
        return result
    (save_dir / 'history.json').write_text(
        json.dumps({k: [float(v) for v in vs] for k, vs in history.items()},
                   indent=1))
    if plots.have_matplotlib():
        plots.plot_training_curves(history,
                                   save_path=save_dir / 'training_curves.png')
        # a fresh single-process loader: the training loaders yield this
        # rank's rows only
        _plot_val_predictions(model, weights_dir / 'best', val_ds,
                              batch_size, workers, device,
                              save_dir / 'val_predictions.png')
    else:
        print(plots.SKIP_MESSAGE)
    print(f'\nResults saved to: {save_dir}')
    if history['tumor_dice']:
        best = max(history['tumor_dice'])
        print(f'Best Tumor Dice: {best:.4f} at epoch '
              f'{start_epoch + history["tumor_dice"].index(best) + 1}')
    return result


def _plot_val_predictions(model, best_dir, val_ds, batch_size, workers,
                          device, save_path):
    """The best weights (when a ``best`` checkpoint exists) on up to 8
    validation slices with tumor; the grid shows 4 of them."""
    from unet_tpu_torch.data.augmentations import normalize_batch
    from unet_tpu_torch.data.dataset import BatchLoader
    from unet_tpu_torch.utils.plots import plot_predictions
    model = copy.deepcopy(model).eval()
    if (best_dir / 'model.pt').exists():
        best = torch.load(best_dir / 'model.pt', map_location='cpu',
                          weights_only=False)
        model.load_state_dict(best['model_state_dict'], strict=True)
        print(f"Loaded best model from epoch {best['epoch'] + 1}")
    images, masks = [], []
    for imgs, msks in BatchLoader(val_ds, batch_size, num_threads=workers,
                                  raw_uint8=True):
        for i in np.flatnonzero(msks.reshape(len(msks), -1).any(1)):
            images.append(imgs[i])
            masks.append(msks[i])
        if len(images) >= 8:
            break
    if not images:
        print('Warning: no tumor samples found in validation set')
        return
    x = normalize_batch(torch.from_numpy(np.stack(images[:8])).to(
        device).float() / 255.0)
    with torch.no_grad():
        logits = model(x)
    plot_predictions(x, np.stack(masks[:8]).astype(np.int64), logits,
                     num_samples=min(4, len(images)), save_path=save_path,
                     class_names=['background', 'tumor'])


if __name__ == '__main__':
    main()
