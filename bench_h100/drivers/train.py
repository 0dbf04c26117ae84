"""Training traffic: the train CLI's own epoch loop on its synthetic
slices, timed from outside.

The run calls ``unet_tpu_torch.cli.train.main`` in this process with a
config written from the cell's configuration and traffic, the
benchmark's seeded weights (``--init-weights``) and ``--synthetic``
slices seeded from the run's seed. Two wrappers, installed on the
program's classes for the run and removed after it, watch the loop
without changing what it computes:

* around ``TrainStep.__call__``: the first three steps are the set-up's
  correctness steps (each step's loss, the first gradient from AdamW's
  first moment, the leaves' change after the third); after ``warmup``
  steps the window opens at a step's entry (synchronised), and at the
  first step entry past ``--seconds`` it synchronises, closes, records
  what the close is held to exactly (``Probe.closing``) and ends the
  loop by raising ``WindowClosed``; with ``--trace 1`` a profile of the
  device alone covers ``trace_steps`` steps inside the window, and a
  second one of ``gap_steps`` steps, with the loop thread's host ops,
  names the idle gaps;
* around ``augment_batch_seeded``: the first three super-batches' uint8
  slices and masks, and the (seed, step) the draws come from.

The CLI's synthetic training set is handed the benchmark's slices (made
on the device from the seed, ``slices.ct_slices``) in its cache before
the loop starts, so its loader threads, pinned prefetch and
augmentation run as they do on a cached epoch, and the slices' making
(22 ms a slice on the host) stays out of the window.

The epoch holds far more slices than a window at several times today's
rate takes, so the window never reaches validation or a checkpoint.
After the window the reference follows the three steps from the same
weights and the benchmark's own copies of the slices.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch
import yaml

from bench_h100 import slices as slicegen
from bench_h100.common import (Context, Outcome, WindowClosed, derive_seed,
                               log, pick_compared)
from bench_h100.weights import seeded_state

CHECK_STEPS = 3
ADAM_BETA1 = 0.9


def job_of(ctx: Context) -> Dict:
    """The cell's training job: the configuration with the traffic's
    batch layout."""
    cfg, tr = ctx.config, ctx.traffic
    return {**cfg, 'batch_size': tr['batch_size'],
            'accumulation_steps': tr['accumulation_steps']}


def cli_config(ctx: Context, job_seed: int) -> Dict:
    """The YAML the train CLI reads."""
    cfg, tr = ctx.config, ctx.traffic
    return {
        'model': cfg['model'],
        'data': {'root': str(ctx.tmp / 'no-data'),
                 'img_size': cfg['img_size'], 'val_ratio': 0.2,
                 'batch_size': tr['batch_size'],
                 'num_workers': cfg['num_workers']},
        'train': {**cfg['train'],
                  'accumulation_steps': tr['accumulation_steps']},
        'scheduler': cfg['scheduler'], 'ema': cfg['ema'],
        'early_stopping': cfg['early_stopping'], 'loss': cfg['loss'],
        'augmentation': cfg['augmentation'],
        'output': {'save_dir': str(ctx.tmp / 'runs'),
                   'experiment_name': ctx.workload, 'save_last': True,
                   'save_best': True},
        'seed': job_seed, 'device': ctx.device,
        'tpu': {**cfg['tpu'], 'data_parallel': 1},
    }


class Probe:
    """State of the two wrappers over one run of the loop."""

    def __init__(self, ctx: Context, init: Dict[str, torch.Tensor],
                 window: bool):
        tr = ctx.traffic
        self.ctx, self.init, self.window = ctx, init, window
        self.open_at = max(int(tr['warmup_steps']), CHECK_STEPS)
        self.trace_from = self.open_at + int(tr['trace_after_steps'])
        self.trace_to = self.trace_from + int(tr['trace_steps'])
        self.step = 0
        self.losses: List[torch.Tensor] = []
        self.grad: Dict[str, torch.Tensor] = {}
        self.after: Dict[str, torch.Tensor] = {}
        self.tracked: Dict[str, int] = {}
        self.raw: List[tuple] = []
        self.aug_args: List[tuple] = []
        self.t_open = self.t_close = None
        self.steps_timed = 0
        self.gaps_to = self.trace_to + int(tr.get('gap_steps', 0))
        self.closed: Dict[str, float] = {}
        self.tracer = None
        self.traced_steps = 0
        if ctx.trace and window:
            from bench_h100.tracing import Window
            dev = torch.device(ctx.device)
            # the metrics' window records the device alone: recording the
            # loop's host ops slows its steps by about a quarter
            self.window_trace = Window(ctx.tmp / 'train_trace.json', dev,
                                       host_ops=False)
            self.gap_trace = Window(ctx.tmp / 'gap_trace.json', dev)
            self.window_trace.warm()
            self.gap_trace.warm()

    def _sync(self):
        if self.ctx.device == 'cuda':
            torch.cuda.synchronize()

    def before(self, ts) -> None:
        i = self.step
        if not self.window:
            return
        if i == self.open_at:
            self._sync()
            self.t_open = time.monotonic()
        elif i > self.open_at and (time.monotonic() - self.t_open
                                   >= self.ctx.seconds):
            self._sync()
            self.t_close = time.monotonic()
            self.steps_timed = i - self.open_at
            if self.tracer is not None:
                raise RuntimeError('the window closed inside the traced '
                                   'steps: give the cell more seconds')
            self.closing(ts)
            raise WindowClosed
        if self.tracer is not None and i in (self.trace_to, self.gaps_to):
            self.tracer.stop()
            self.tracer = None
            if i == self.trace_to:
                self.traced_steps = self.trace_to - self.trace_from
        if self.ctx.trace and i == self.trace_from:
            self.tracer = self.window_trace
        elif self.ctx.trace and i == self.trace_to < self.gaps_to:
            self.tracer = self.gap_trace
        if self.tracer is not None and i in (self.trace_from, self.trace_to):
            self.tracer.start()

    @torch.no_grad()
    def closing(self, ts) -> None:
        """What the window's close is held to exactly, after the steps
        the window timed: ``window_counts``, the BatchNorm layers whose
        update count is not one per microbatch of every step run, and the
        parameters (and the step object) whose count of AdamW steps is not
        the steps run; ``window_nonfinite``, the leaves of the model's
        state holding a non-finite value."""
        accum = self.ctx.traffic['accumulation_steps']
        state = ts.model.state_dict()
        bad = sum(int(v) != int(self.init[k]) + self.step * accum
                  for k, v in state.items()
                  if k.endswith('num_batches_tracked'))
        bad += sum(int(ts.opt.state.get(p, {}).get('step', 0)) != self.step
                   for p in ts.model.parameters())
        bad += int(ts.steps != self.step)
        self.closed = {
            'window_counts': float(bad),
            'window_nonfinite': float(sum(
                not bool(torch.isfinite(v).all()) for v in state.values()
                if v.is_floating_point()))}

    @torch.no_grad()
    def after_step(self, ts, loss_sum: torch.Tensor) -> None:
        i = self.step
        self.step += 1
        if i >= CHECK_STEPS:
            return
        self.losses.append(loss_sum.detach().clone())
        named = dict(ts.model.named_parameters())
        if i == 0:
            # AdamW's first moment after one step is (1 - beta1) g; a
            # step that never reached the optimizer left it no state
            zero = torch.zeros(())
            self.grad = {k: torch.linalg.vector_norm(
                ts.opt.state[p]['exp_avg'] / (1 - ADAM_BETA1))
                if 'exp_avg' in ts.opt.state[p] else zero
                for k, p in named.items()}
        if i == CHECK_STEPS - 1:
            state = ts.model.state_dict()
            self.after = {k: torch.linalg.vector_norm(state[k].float()
                                                      - self.init[k].float())
                          for k in state
                          if not k.endswith('num_batches_tracked')}
            self.tracked = {k: int(v) for k, v in state.items()
                            if k.endswith('num_batches_tracked')}
            if not self.window:
                raise WindowClosed

    def augment(self, images, masks, seed, step) -> None:
        if len(self.raw) < CHECK_STEPS:
            self.raw.append(((images[:, 0] * 255.0).round().to(torch.uint8),
                             masks.clone()))
            self.aug_args.append((int(seed), int(step)))


def install(probe: Probe, pool):
    """Wrap the program's step and augmentation call, and hand its
    synthetic training set the benchmark's slices: ``pool`` is (images,
    masks, place in the first epoch of each slice index). Returns the
    undo."""
    from unet_tpu_torch.data import augmentations, dataset
    from unet_tpu_torch.train.trainer import TrainStep
    step_call = TrainStep.__call__
    aug_call = augmentations.augment_batch_seeded
    synthetic = dataset.SyntheticSliceDataset

    def call(ts, images, masks, lr, mb_mask, ema=None):
        probe.before(ts)
        out = step_call(ts, images, masks, lr, mb_mask, ema)
        probe.after_step(ts, out)
        return out

    def aug(images, masks, seed, step, *a, **k):
        probe.augment(images, masks, seed, step)
        return aug_call(images, masks, seed, step, *a, **k)

    class Pooled(synthetic):
        """The CLI's synthetic set with its uint8 cache filled up front:
        slice index i holds pool slice (i's place in the first epoch) mod
        the pool's size, so the first pool-size slices visited all
        differ."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            if k.get('split') != 'train':
                return
            imgs, masks, place = pool
            if len(self.files) != len(place):
                raise RuntimeError(f'{len(self.files)} training slices, '
                                   f'{len(place)} expected')
            for i in range(len(self.files)):
                j = int(place[i]) % len(imgs)
                self._cache[i] = (imgs[j], masks[j])

    TrainStep.__call__ = call
    augmentations.augment_batch_seeded = aug
    dataset.SyntheticSliceDataset = Pooled

    def undo():
        TrainStep.__call__ = step_call
        augmentations.augment_batch_seeded = aug_call
        dataset.SyntheticSliceDataset = synthetic
    return undo


def first_batches(pool_u8: torch.Tensor, pool_m: torch.Tensor,
                  per_step: int, steps: int) -> List[tuple]:
    """The slices of the first ``steps`` super-batches in the order a
    super-batch holds them: the first epoch visits pool slices 0, 1, 2,
    ... (``Pooled``)."""
    out = []
    for s in range(steps):
        idx = torch.arange(s * per_step, (s + 1) * per_step) % len(pool_u8)
        out.append((pool_u8[idx], pool_m[idx]))
    return out


def drive(ctx: Context, window: bool = True) -> Dict:
    """Set up and run the loop: until the window closes, or through the
    correctness steps alone with ``window=False``. Returns the readings
    with the program's state freed."""
    from unet_tpu_torch.cli import train as train_cli
    tr = ctx.traffic
    job_seed = derive_seed(ctx.seed, 'job')
    w_seed = derive_seed(ctx.seed, 'weights')
    dev = torch.device(ctx.device)
    init = seeded_state(ctx.config['model'], w_seed, dev)
    ctx.tmp.mkdir(parents=True, exist_ok=True)
    pt = ctx.tmp / 'init.pt'
    torch.save({'model_state_dict': {k: v.cpu() for k, v in init.items()}},
               pt)
    cfg_path = ctx.tmp / 'train.yaml'
    cfg_path.write_text(yaml.safe_dump(cli_config(ctx, job_seed)))
    argv = ['--config', str(cfg_path), '--synthetic',
            '--synthetic-volumes', str(tr['volumes']),
            '--synthetic-slices', str(tr['slices_per_volume']),
            '--init-weights', str(pt)]
    pool_u8, pool_m = slicegen.ct_slices(derive_seed(ctx.seed, 'slices'),
                                         tr['pool_slices'],
                                         ctx.config['img_size'], dev)
    pool_u8, pool_m = pool_u8.cpu(), pool_m.cpu()
    order = slicegen.epoch_order(job_seed, slicegen.train_count(
        tr['volumes'], tr['slices_per_volume']))
    place = np.empty_like(order)
    place[order] = np.arange(len(order))
    probe = Probe(ctx, init, window)
    if ctx.device == 'cuda':
        torch.cuda.reset_peak_memory_stats()
    undo = install(probe, (pool_u8.numpy(), pool_m.numpy(), place))
    try:
        train_cli.main(argv)
        raise RuntimeError('the epoch ended before the window closed: give '
                           'the traffic more volumes')
    except WindowClosed:
        pass
    finally:
        undo()
    peak = (torch.cuda.max_memory_allocated() if ctx.device == 'cuda'
            else 0)
    readings = {
        'loss': [float(x) for x in probe.losses],
        'grad': {k: float(v) for k, v in probe.grad.items()},
        'change': {k: float(v) for k, v in probe.after.items()
                   if not k.endswith(('running_mean', 'running_var'))},
        'stats': {k: float(v) for k, v in probe.after.items()
                  if k.endswith(('running_mean', 'running_var'))},
        'tracked': probe.tracked, 'closed': probe.closed,
        'raw': [(a.cpu(), b.cpu()) for a, b in probe.raw],
        'aug_args': probe.aug_args,
        'job_seed': job_seed, 'init': {k: v.cpu() for k, v in init.items()},
        'pool': (pool_u8, pool_m),
        'peak': peak, 'probe': probe,
    }
    del probe.init, init
    gc.collect()
    if ctx.device == 'cuda':
        torch.cuda.empty_cache()
    return readings


def judge(ctx: Context, r: Dict, control: bool = False) -> Dict:
    """The numbers compared (``reference.train.compare``) between the
    program's readings and the reference's three steps from the same
    weights and slices, plus ``rows``: the rows of the program's first
    super-batches that are not the benchmark's slices, and ``draws``:
    augmentation calls whose (seed, step) are not the job's (seed + 1,
    step). With ``control`` it returns a dict of such numbers by source:
    ``program``, ``control`` (the reference in float8 in the program's
    place) and ``half_batch`` (the reference with that fault planted)."""
    from bench_h100.reference import train as ref
    tr = ctx.traffic
    per_step = tr['batch_size'] * tr['accumulation_steps']
    want_batches = first_batches(*r['pool'], per_step, CHECK_STEPS)
    bad_rows = abs(len(r['raw']) - CHECK_STEPS) * per_step
    for (u8, m), (wu8, wm) in zip(r['raw'], want_batches):
        bad_rows += int(((u8 != wu8).flatten(1).any(1)
                         | (m != wm).flatten(1).any(1)).sum())
    bad_draws = sum(a != (r['job_seed'] + 1, i)
                    for i, a in enumerate(r['aug_args']))
    dev = torch.device(ctx.device)
    batches = [(a.to(dev), b.to(dev)) for a, b in want_batches]
    state = {k: v.to(dev) for k, v in r['init'].items()}

    def follow(**fault):
        return ref.follow(ctx.config['model'], job_of(ctx), state, batches,
                          r['job_seed'] + 1, dev, **fault)

    want = follow()
    nums = ref.compare(r, want)
    nums['rows'] = float(bad_rows)
    nums['draws'] = float(bad_draws)
    nums.update(r['closed'])
    # the clip is in force where this is over the job's grad_clip; a
    # step that skipped it would then read grad_median about this less 1
    nums['reference_grad_norm'] = want['grad_norm'][0]
    if not control:
        return nums
    return {'program': nums,
            'control': ref.compare(follow(fp8=True), want),
            'half_batch': ref.compare(follow(half_batch=True), want)}


def run(ctx: Context) -> Outcome:
    from bench_h100.yardstick import model_flops_per_slice
    r = drive(ctx)
    probe = r['probe']
    tr = ctx.traffic
    per_step = tr['batch_size'] * tr['accumulation_steps']
    window_s = probe.t_close - probe.t_open
    rate = probe.steps_timed * per_step / window_s
    setup_s = probe.t_open - ctx.t_start
    log(f'window: {probe.steps_timed} optimizer steps of {per_step} slices '
        f'in {window_s:.3f} s; set-up {setup_s:.3f} s')
    t = time.monotonic()
    nums = judge(ctx, r)
    log(f'reference: {time.monotonic() - t:.3f} s')
    comp = pick_compared(nums, ctx.limits)
    layer, trace = {}, None
    if probe.traced_steps:
        trace = probe.window_trace.summary()
        if probe.gaps_to > probe.trace_to:
            trace.gaps = probe.gap_trace.summary().gaps
        flops = model_flops_per_slice(ctx.config['model'],
                                      ctx.config['img_size'])
        layer = {'cell': 'train',
                 'slices_traced': probe.traced_steps * per_step,
                 'flops_per_slice': flops,
                 'warp_rows': per_step, 'img_size': ctx.config['img_size']}
    kind = (torch.cuda.get_device_name() if ctx.device == 'cuda'
            else 'cpu')
    return Outcome(end_to_end={'train_slices_per_s': rate,
                               'setup_s': setup_s},
                   attempted=probe.steps_timed, failed=0, compared=comp,
                   memory_peak_bytes=int(r['peak']), device_kind=kind,
                   device_count=ctx.chips, layer=layer, trace=trace)

