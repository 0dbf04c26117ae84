#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``unet_tpu_torch``) on one card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero, printing no result):

1. build the hand-written CUDA kernels from ``unet_tpu_torch/csrc`` with
   nvcc (sm_90a), one nvcc per source started together, and print the
   card's name and power limit;
2. hold each kernel against its plain PyTorch version at the shapes the
   main paths give it: the attention gate in float32 and bfloat16, the
   warp at 32 x 512^2 on augmentation-drawn, scattered and all-.5-tie
   coordinates (masks identical, images bit-identical);
3. AttentionUNet-64 at 512^2, batch 8, bf16, channels_last, random
   weights from a seed and calibrated BatchNorm statistics: the fused
   gate launches 4 kernels per forward, and its logits match the same
   weights with the fused gate off;
4. the 3x3 conv kernel at all 17 convs of that model with Cin, Cout >=
   64 (the guard refuses the 1->64 stem), on the model's own weights and
   captured activations: 17 counted forward launches at batch 8 and 17
   data-gradient launches at batch 4; each held against its plain
   version in bf16 and f32, the fused BN+ReLU epilogue against the
   module route, dk against F.conv2d's autograd; times beside the bound
   and cuDNN's; before it, the conv on shapes whose tiles hang over the
   map's edges (N=3, 37x50, 64->128 and 128->64, and a 5x3 map) and on
   widths that take the kernel's other routes (256->64, 64->192,
   192->384), and the gate on a non-square shape (N=3, g 128x24x40, x
   128x48x80), on the widest gates of a base-128 and a base-8 model
   (I = 512 and I = 4) and on widths that end inside a chunk; the gate's
   band form (``GateBand``, the sharded forward's) at the four 512^2
   gates, four bands and an uneven split, equal to the rows of the
   whole map's launch bit for bit;
5. the serving path: ``create_server`` serving that model (saved as a
   reference-format .pt) to concurrent HTTP clients, with the gate
   kernel's launch count read around the run;
6. the directory predict CLI on 40 synthetic PNGs of mixed sizes and a
   corrupt one, with the fused gate on (4 gate launches per chunk), a
   threshold sweep and overlays, masks held against the direct pipeline;
7. data-parallel inference in one process (``core/mesh.py``) on two
   replicas of the card (and on every GPU where there are several): a
   bf16 row's result depends on the batch size and on its place in the
   batch, so the split is held against one device on the same rows in
   the same places, bit for bit: ``ReplicaSet.run`` against the
   one-device step on its blocks, ``create_server`` on the replicas
   against the one-device server at batch 8 / k on requests sent alone
   (after the serve phase's kind of traffic from 16 clients;
   ``/healthz`` says ``data_parallel`` k), the predict CLI's PNGs
   against the one-device run at batch 8 / k; the gate kernel launches
   4 times per forward on each replica (counted by stream); slices/s,
   p50 and peak memory per device beside one device;
8. the height-sharded forward (``core/spatial.py``) of that model at
   512^2, batch 1 and 8, over four bands of the card (and over every
   GPU where there are several), the gate kernel launching on every band
   (4 per forward on each, counted by device and band): float32 (TF32
   off) probabilities within 1e-4 of the unsharded forward, bfloat16
   adding no error beyond bf16's against the float32 forward; ms per
   forward and peak memory beside the unsharded; then ``--spatial-shard``
   through the predict CLI;
9. the training path: ``unet_tpu_torch.cli.train`` on
   ``configs/lung_tumor.yaml`` as written (bf16, batch 4 x accumulation
   8, augmentation on) on 20 synthetic volumes for 2 epochs, from random
   weights of a seed, with the warp kernel's launch count read around
   the run (one per super-batch); every loss finite, the weights moved,
   and the saved ``weights/last/model.pt`` serves a 512^2 slice through
   ``cli/predict.load_model``; then the same run with augmentation off;
10. ``--resume`` of that run to a third epoch with ``--profile-dir``
   (epoch 3, one warp launch per super-batch, the trace names the warp
   kernel, plots drawn or skipped with one line); then
   ``cli/export_torch.py`` on the first run's ``weights/best``:
   ``load_model`` reads the directory and the exported .pt to equal
   logits;
11. the overfit CLI (``--synthetic --model attention_unet``, 100 of its
   default 200 epochs) must PASS;
12. the slice cache: 80 synthetic 512^2 PNGs written through PIL,
   ``build_cache`` (printing which builder ran), ``CachedSliceDataset``
   held byte for byte against ``SliceDataset`` on every slice, the loader
   alone timed on the cache and on the PNGs, then the train CLI with
   ``--cache`` on ``configs/lung_tumor.yaml`` for 2 epochs (warp launches
   counted around it);
13. two ranks on the one card, each a process of this script
   (``--dist-worker``), over gloo: NCCL refuses two ranks on one device.
   The one-step parity (loss and gradient norm after the step's one
   reduction, a fixed global batch of 4, float32 and bfloat16) against
   this process; one rank's step, its gradient all-reduce and a
   BatchNorm all-reduce timed; then the train CLI with ``--num-processes
   2`` on the same config, init and cache: warp launches on each rank,
   one run directory, the final weights within a stated distance of the
   single-process ``--cache`` run's. With more than one GPU, also one
   NCCL rank per GPU spawned by one command through ``tpu.data_parallel``,
   each rank's warp launches read from the CLI's report;
14. times (CUDA events) of each kernel beside its bound and plain version,
   of the model forward, of serving, of the augmentation program and its
   draws, and of one optimizer step (8 microbatches forward and backward,
   clip, AdamW); the host cost of one launch of the conv's and the gate's
   wrappers (their TMA tensor maps are encoded on every launch).

The train CLI phases that count launches in this process run on a copy
of the config with ``tpu.data_parallel: 1``: the config's -1 would spawn
one rank per GPU on a host with several. Each phase's seconds are
printed before the result lines.

The line before the last lists the kernels as JSON, every number in it
measured or computed by this run, and the last line is
``{"ok": true, "device": {...}}``. Exits 2 when no CUDA device is
available. Imports nothing of JAX or of the JAX package.

Two measurement modes run instead of the smoke:
``python3 chip_smoke.py --inference-ab PARENT_DIR PAIRS`` runs the serve
and predict phases of another checkout (``git archive`` of a parent
commit, unpacked) and of this one alternately on the same host, one
process a run, and prints each run's slices/s and the medians;
``python3 chip_smoke.py --memory-ceiling`` finds the largest square
image the unsharded bf16 forward takes on one card, at batch 1 and 8.
"""

import contextlib
import glob
import http.client
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# the H100 SXM's published peaks (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {'bfloat16': 989e12,   # tensor cores
              'float32': 67e12}     # FMA outside the tensor cores

DEVICE = 'cuda'
BATCH = 8
IMG = 512
BASE = 64
# the four decoder gates of AttentionUNet-64 at 512^2: (Cg, h_in, Cx, I);
# g is (N, Cg, h, h), x is (N, Cx, 2h, 2h)
GATES = [(512, 32, 512, 256), (256, 64, 256, 128),
         (128, 128, 128, 64), (64, 256, 64, 32)]
# more gates the model's guard admits and no 512^2 AttentionUNet-64 has:
# one neither square nor a power of two, so tiles hang over the right edge
# (W = 80 is five tiles of 16) and the g patch over the last source column;
# the widest gate of a base-128 model (I = 512: two passes of the widest
# accumulator); the widest gate of a base-8 model (I = 4: padded to 8);
GATE_EXTRA = [dict(n=3, cg=128, h=24, w=40, cx=128, inter=64),
              dict(n=2, cg=1024, h=16, w=16, cx=1024, inter=512),
              dict(n=2, cg=8, h=16, w=16, cx=8, inter=4),
              # channel counts that end inside a 64-channel chunk
              dict(n=1, cg=80, h=16, w=24, cx=72, inter=36),
              # channel counts that are no multiples of 8, which the
              # wrapper pads with zeros for the bf16 kernel: the narrowest
              # gate of a base-4 model, and Cg, Cx and I all odd ones out
              dict(n=2, cg=4, h=16, w=16, cx=4, inter=2),
              dict(n=2, cg=20, h=16, w=24, cx=12, inter=6)]
# kernel vs plain. float32: the tests' tolerance (tests/test_pallas.py:33).
# bfloat16: the plain version rounds each einsum and the sum to bf16
# where the kernel keeps f32, so att can differ by a few bf16 steps
# (2^-8 relative) and out = x * att inherits that times |x| (up to ~5
# for these normal inputs), plus out's own rounding.
TOL = {'float32': dict(rtol=1e-4, atol=1e-5),
       'bfloat16': dict(rtol=2e-2, atol=2e-2)}
# model logits with the fused gate against the module gates, same weights.
# float32: the same function up to summation order, so max |diff| is held
# to 1e-3 of max |logit| (tests/test_models.py:143-146 allows rtol 2e-2
# over the 23-conv stack). bfloat16: each route rounds at other points,
# so both are held against the float32 module route: the fused route's
# error (max and mean) may not exceed the module route's own bf16 error
# by more than 25%, i.e. the kernel adds no error beyond bf16's.
MODEL_TOL_F32 = 1e-3
MODEL_TOL_BF16 = 1.25
CLIENTS = 16
REQUESTS_PER_CLIENT = 8
# the request sizes of the serve phase's traffic (H, W)
SERVE_SIZES = [(512, 512), (400, 300), (256, 256), (600, 520), (512, 384),
               (333, 517), (128, 200), (700, 700)]
# the training super-batch: batch 4 x accumulation 8 at 512^2
TRAIN_CONFIG = 'configs/lung_tumor.yaml'
SUPER = 32
TRAIN_ARGS = ['--synthetic', '--synthetic-volumes', '20',
              '--synthetic-slices', '4', '--epochs', '2']
TRAIN_SUPERBATCHES = 4   # 16 train volumes x 4 slices / 32, two epochs
# the warp kernel against its plain version: both round every operation
# once in the same order, so images must be bit-identical; if they are
# not, the ULP histogram is printed and images are held to 2 ULP
WARP_MAX_ULP = 2
# the 3x3 conv kernel: every 3x3 conv of AttentionUNet-64 with Cin and
# Cout >= 64 (the 1->64 stem stays on cuDNN). Kernel vs plain: float32 at
# the JAX golden tests' 1e-4 (tests/test_pallas_conv.py:43); bfloat16 and
# the data gradient to one bf16 step of the larger value, plus 1e-3 of
# the conv's largest |value|: both sum exact products in f32 and round
# once, so they differ by the f32 sums' order (and the tensor cores'
# accumulation), which moves a value by one step at most except near
# zero, where the terms cancel and that f32 difference, which scales with
# the terms, exceeds a bf16 step of the tiny result. The
# weight gradient (cuDNN in both routes, float32) is held to 1e-3 of the
# largest |dk|: 1e-3 as tests/test_pallas_conv.py:73, relative because dk
# sums 4 x 512^2 products here. The fused BN+ReLU epilogue is held as the
# gate is: its error against the float32 module route may exceed the bf16
# module route's by at most 25%.
N_CONVS = 17
# ``ms`` of the kernels' earlier designs at the same shapes, printed on the
# time lines beside the new times and nowhere in the ``kernels`` line
# (NVIDIA H100 80GB HBM3, 700.00 W, this script before the tensor-core
# redesign): the conv through wmma on four warps with a two-stage cp.async
# pipeline, the gate's f32 FMA GEMM on the CUDA cores
PREV_MS = {'conv3x3': 15.6088, 'attention_gate': 6.0650}
CONV_BATCH_BWD = 4
CONV_F32_TOL = dict(rtol=1e-4, atol=1e-4)
CONV_BF16_ATOL = 1e-3
CONV_DK_TOL = 1e-3
CONV_EPILOGUE_TOL = MODEL_TOL_BF16
# shapes no model gives the conv (all of those are powers of two): (N, H, W,
# Cin, Cout) whose tiles of 8 x 16 pixels hang over the bottom and right
# edges, and one map smaller than a single tile
CONV_EDGE_SHAPES = [(3, 37, 50, 64, 128), (3, 37, 50, 128, 64),
                    (2, 5, 3, 64, 64),
                    # widths no model conv has, which take the kernel's other
                    # routes: 64-wide tiles whose weights do not stay resident
                    # (too many, or several channel blocks), and channel
                    # counts that are no power of two
                    (2, 20, 33, 256, 64), (1, 9, 17, 64, 192),
                    (1, 8, 16, 192, 384)]

# the overfit CLI's depth: half its default 200 epochs, to make room for
# the cache and two-rank phases (its tumor Dice read 0.9993 at epoch 100
# and 1.0000 at 200 on the H100; the bar is 0.8)
OVERFIT_EPOCHS = 100
# the slice cache phase: synthetic PNGs of (volumes, slices per volume),
# the same data as the train phase (16 training volumes x 4 slices)
CACHE_DATA = (20, 4)
# two ranks on the one card over gloo. The one-step parity's fixed global
# batch (2 rows per rank) and its tolerances, relative: float32 sums the
# same products in other orders (BatchNorm sums split over the ranks,
# cuDNN at batch 2 against 4), as tests/test_multihost.py holds JAX's two
# processes (loss 1e-5, gradient norm 1e-4; the norm here is twice that:
# this norm of 58 is measured 4.5e-5 apart on the H100, and a row mix-up
# moves it by percents); bfloat16 rounds each activation, so an order
# difference moves a value by a bf16 step (2^-8) where it lands on a
# rounding boundary, and the loss and norm by a fraction of that
# (measured up to 1.10e-3 and 1.09e-3 on the H100; planted rank-local
# BatchNorm statistics moved the bf16 norm by 1.3e-2 there, the f32 one
# by 9.1e-3).
DIST_BATCH = 4
DIST_TOL = {'float32': {'loss': 1e-5, 'gnorm': 2e-4},
            'bfloat16': {'loss': 5e-3, 'gnorm': 5e-3}}
# the 2-epoch run against one process: AdamW turns the noise of near-zero
# gradients into up to +-lr per step (tests/test_multihost.py:1-16), so
# the weights are held loosely: their distance from the single-process
# weights at most DIST_DRIFT of the distance those moved from the init
# (measured 0.0824-0.0831 on the H100; planted faults read 0.50 with
# rank-local augmentation draws, whose epoch-2 losses stayed within 0.005
# of one process, and 0.42 with rank-local BatchNorm statistics), and
# the epoch-2 losses within DIST_LOSS (measured 0.0005 apart)
DIST_DRIFT = 0.25
DIST_LOSS = 0.1
DIST_TIMEOUT = 600


def log(*a):
    print(*a, flush=True)


PHASE_SECONDS = {}


def timed(name, fn, *args):
    """fn(*args), its wall seconds kept under ``name``."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[name] = round(time.perf_counter() - t0, 1)
    return out


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    if not out:
        raise RuntimeError('nvidia-smi printed no card')
    return out[0].strip()


def sync():
    import torch
    if DEVICE == 'cuda':
        torch.cuda.synchronize()


def time_ms(fn, reps, flush=None):
    """Mean device ms of fn() from CUDA events around each call, after
    two warm-up calls; flush (a large buffer) is zeroed before each call
    so inputs come from device memory, not L2."""
    import torch
    for _ in range(2):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        if flush is not None:
            flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / reps


# ---------------------------------------------------------------- gates

def gate_inputs(cg, h, cx, inter, dtype, seed, n=None, w=None):
    """Random folded-gate arguments on the card, weights ~ 1/sqrt(fan_in)
    so the pre-activations are O(1) and the sigmoid is not saturated.
    g is (n, cg, h, w), x (n, cx, 2h, 2w); n defaults to BATCH, w to h."""
    import torch
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    dev, cl = DEVICE, torch.channels_last
    n = BATCH if n is None else n
    w = h if w is None else w

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    g = rnd(n, cg, h, w).to(dtype=dtype, memory_format=cl)
    x = rnd(n, cx, 2 * h, 2 * w).to(dtype=dtype, memory_format=cl)
    k = cg + cx
    return (g, x, rnd(cg, inter, scale=k ** -0.5).to(dtype),
            rnd(cx, inter, scale=k ** -0.5).to(dtype),
            rnd(inter, scale=0.1), rnd(inter, 1, scale=inter ** -0.5).to(dtype),
            rnd(1, scale=0.1))


def gate_bound(cg, h, cx, inter, dtype):
    """Least time for one gate at BATCH: each input read once and the
    output written once, or its flops at the type's peak."""
    import torch
    e = torch.tensor([], dtype=dtype).element_size()
    pix_out = BATCH * (2 * h) ** 2
    nbytes = (BATCH * h * h * cg + 2 * pix_out * cx
              + (cg + cx + 1) * inter) * e + 4 * (inter + 1)
    flops = 2 * (cg + cx + 1) * inter * pix_out
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype).split('.')[-1]] * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                 else 'operations'), nbytes, flops


def check_gates():
    import torch
    from unet_tpu_torch.ops import attention_gate as ag
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split('.')[-1]
        for i, (cg, h, cx, inter) in enumerate(GATES):
            args = gate_inputs(cg, h, cx, inter, dtype, seed=i)
            got = ag.attention_gate_fused(*args)
            want = ag.attention_gate_reference(*args)
            sync()
            assert got.shape == want.shape and got.dtype == dtype
            assert torch.isfinite(got).all()
            err = (got.float() - want.float()).abs().max().item()
            log(f'gate {i + 1} g={cg}x{h}^2 x={cx}x{2 * h}^2 I={inter} '
                f'{name}: max |kernel - plain| = {err:.3g}')
            torch.testing.assert_close(got.float(), want.float(),
                                       **TOL[name])
            errs[(i, name)] = err
        for j, e in enumerate(GATE_EXTRA):
            args = gate_inputs(e['cg'], e['h'], e['cx'], e['inter'], dtype,
                               seed=len(GATES) + j, n=e['n'], w=e['w'])
            assert ag.fused_shapes_supported(tuple(args[0].shape),
                                             tuple(args[1].shape))
            got = ag.attention_gate_fused(*args)
            want = ag.attention_gate_reference(*args)
            sync()
            assert got.shape == want.shape and got.dtype == dtype
            assert torch.isfinite(got).all()
            err = (got.float() - want.float()).abs().max().item()
            log(f'gate extra n={e["n"]} g={e["cg"]}x{e["h"]}x{e["w"]} '
                f'x={e["cx"]}x{2 * e["h"]}x{2 * e["w"]} I={e["inter"]} '
                f'{name}: max |kernel - plain| = {err:.3g}')
            torch.testing.assert_close(got.float(), want.float(),
                                       **TOL[name])
    return errs


def check_gate_bands():
    """The gate's band form, as the height-sharded forward launches it:
    at each 512^2 gate in both types, x split into SPATIAL_BANDS bands
    (the sharded forward's edges at that level) and into three uneven
    ones (5, 2h - 8 and 3 rows), each band launched with the g rows it
    reads (``GateBand``). The bands joined equal the whole map's launch
    bit for bit (the taps are computed on the global rows with the same
    arithmetic), and each band is held against the plain band version."""
    import torch
    from unet_tpu_torch.core.spatial import band_edges
    from unet_tpu_torch.ops import attention_gate as ag
    from unet_tpu_torch.ops.resize import source_rows
    cl = torch.channels_last
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split('.')[-1]
        for i, (cg, h, cx, inter) in enumerate(GATES):
            g, x, *rest = gate_inputs(cg, h, cx, inter, dtype, seed=i)
            whole = ag.attention_gate_fused(g, x, *rest)
            level = [e * 2 * h // IMG for e in band_edges(IMG, SPATIAL_BANDS)]
            for edges in (level, [0, 5, 2 * h - 3, 2 * h]):
                parts, err = [], 0.0
                for s, e in zip(edges[:-1], edges[1:]):
                    lo, hi = source_rows(h, 2 * h, s, e)
                    args = (g[:, :, lo:hi].contiguous(memory_format=cl),
                            x[:, :, s:e].contiguous(memory_format=cl),
                            *rest, ag.GateBand(s, lo, h, 2 * h))
                    got = ag.attention_gate_fused(*args)
                    want = ag.attention_gate_reference(*args)
                    torch.testing.assert_close(got.float(), want.float(),
                                               **TOL[name])
                    err = max(err, (got.float() - want.float()).abs()
                              .max().item())
                    parts.append(got)
                joined = torch.cat(parts, 2)
                sync()
                same = torch.equal(joined, whole)
                log(f'gate {i + 1} {name} on bands {edges}: joined bands '
                    f'equal the whole map\'s launch bit for bit: {same}; '
                    f'max |band kernel - plain band| = {err:.3g}')
                assert same


# ---------------------------------------------------------------- warp

def warp_bound(n, h, w):
    """Least time for one warp: rows and cols in (8 B/px), the image in
    and out (4 B each), the uint8 mask in and out (1 B each); ~20 flops
    per pixel are nothing against the card's rate."""
    nbytes = n * h * w * (8 + 4 + 4 + 1 + 1)
    return nbytes / HBM_BYTES_PER_S * 1e3, 'bytes', nbytes


def warp_cases(seed=0):
    """The warp's inputs at the training shape (SUPER x IMG^2): images,
    uint8 masks, and three coordinate sets: the port's own augmentation
    draws under the config's probabilities, scattered coordinates
    running 6 px past every border, and all-.5 ties."""
    import torch
    from unet_tpu_torch.data.augmentations import (AugmentConfig,
                                                   draw_augment_params,
                                                   sampling_grid)
    from unet_tpu_torch.utils.config import load_config
    n, h, w = SUPER, IMG, IMG
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    img = torch.rand(n, 1, h, w, generator=gen, device=DEVICE)
    msk = (torch.rand(n, h, w, generator=gen, device=DEVICE) > 0.7).to(
        torch.uint8)
    cfg = AugmentConfig.from_yaml(load_config(TRAIN_CONFIG)['augmentation'])
    params = draw_augment_params(n, h, w, cfg, gen, torch.device(DEVICE))
    cases = {'augment': sampling_grid(params, cfg, h, w)}
    cases['scatter'] = (
        torch.rand(n, h, w, generator=gen, device=DEVICE) * (h + 12) - 6,
        torch.rand(n, h, w, generator=gen, device=DEVICE) * (w + 12) - 6)
    rr = torch.arange(h, dtype=torch.float32, device=DEVICE)
    cc = torch.arange(w, dtype=torch.float32, device=DEVICE)
    cases['ties'] = ((rr[None, :, None] + 0.5).expand(n, h, w).contiguous(),
                     (cc[None, None, :] + 0.5).expand(n, h, w).contiguous())
    return img, msk, cases


def ulp_histogram(got, want):
    """Counts of |got - want| in f32 units in the last place: 0, 1, 2,
    more (equal values, such as 0.0 and -0.0, count as 0)."""
    import torch
    d = (got.view(torch.int32).long() - want.view(torch.int32).long()).abs()
    d = torch.where(got == want, torch.zeros_like(d), d)
    return [int((d == k).sum()) for k in (0, 1, 2)] + [int((d > 2).sum())]


def check_warp():
    import torch
    from unet_tpu_torch.ops import warp
    img, msk, cases = warp_cases()
    err = 0.0
    for name, (rows, cols) in cases.items():
        got_i, got_m = warp.grid_sample_fused(img, msk, rows, cols)
        want_i, want_m = warp.grid_sample_fused_reference(img, msk, rows,
                                                          cols)
        sync()
        assert got_i.shape == want_i.shape and got_m.dtype == torch.uint8
        valid = float(((rows >= 0) & (rows <= IMG - 1) & (cols >= 0)
                       & (cols <= IMG - 1)).float().mean())
        hist = ulp_histogram(got_i, want_i)
        e = (got_i - want_i).abs().max().item()
        err = max(err, e)
        log(f'warp {name} {SUPER}x{IMG}^2 ({valid:.1%} px in range, '
            f'{int(got_m.sum())} mask px): masks identical '
            f'{bool(torch.equal(got_m, want_m))}, images bit-identical '
            f'{hist[0] == got_i.numel()} (ULP histogram 0/1/2/>2: {hist}), '
            f'max |kernel - plain| = {e:.3g}')
        assert torch.equal(got_m, want_m), f'warp {name}: masks differ'
        assert hist[3] == 0, f'warp {name}: images beyond {WARP_MAX_ULP} ULP'
    return err


# ---------------------------------------------------------------- model

def gates_of(model):
    from unet_tpu_torch.models.layers import AttentionGate
    return [m for m in model.modules() if isinstance(m, AttentionGate)]


def set_fused(model, on):
    for g in gates_of(model):
        g.use_fused = on


def calibrate(model, x, seed):
    """Give every BatchNorm statistics measured on x (each set before it
    normalizes, so the next layers see normalized activations), then move
    them and the affine params off those values so folding does real
    work. Finally centre the head, so tumor probabilities spread around
    0.5 and thresholds cut through the masks."""
    import torch
    from unet_tpu_torch.models.layers import TorchBatchNorm
    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def rnd(n):
        return torch.randn(n, generator=gen, device=DEVICE)

    def hook(bn, inputs):
        a = inputs[0].float()
        mean, var = a.mean((0, 2, 3)), a.var((0, 2, 3))
        c = mean.numel()
        bn.running_mean.copy_(mean + 0.1 * var.sqrt() * rnd(c))
        bn.running_var.copy_(var * torch.exp(0.1 * rnd(c)))
        bn.weight.copy_(1.0 + 0.1 * rnd(c))
        bn.bias.copy_(0.1 * rnd(c))

    set_fused(model, False)  # every gate BatchNorm runs as a module
    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, TorchBatchNorm)]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in handles:
            h.remove()
    with torch.no_grad():
        logits = model(x)
        model.outc.conv.bias[1] -= (logits[:, 1] - logits[:, 0]).median()


def check_model(card):
    import torch
    from unet_tpu_torch.models import create_model
    from unet_tpu_torch.ops import attention_gate as ag

    model = create_model('attention_unet', base_features=BASE,
                         dtype=torch.bfloat16, use_fused_gate=True,
                         generator=torch.Generator().manual_seed(0))
    model = model.to(DEVICE, memory_format=torch.channels_last).eval()
    rng = np.random.default_rng(1)
    u8 = np.stack([_image(rng, IMG, IMG) for _ in range(BATCH)])[:, None]
    x = (torch.from_numpy(u8).to(DEVICE).float() / 255.0 - 0.5) / 0.5
    calibrate(model, x[:2], seed=2)

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split('.')[-1]
        model.dtype = dtype
        with torch.no_grad():
            set_fused(model, True)
            ag.launch_count = 0
            out[name, True] = model(x)
            sync()
            launches = ag.launch_count
            set_fused(model, False)
            out[name, False] = model(x)
        assert launches == 4, f'{launches} gate kernel launches per forward'
        for y in (out[name, True], out[name, False]):
            assert y.shape == (BATCH, 2, IMG, IMG) and y.dtype == torch.float32
            assert torch.isfinite(y).all()
        log(f'model {name} b{BATCH} {IMG}^2: {launches} gate kernel '
            f'launches per forward')
    ref = out['float32', False]
    scale = ref.abs().max().item()
    err = {k: (v - ref).abs() / scale for k, v in out.items()}
    for (name, on), e in err.items():
        agree = (out[name, on].argmax(1) == ref.argmax(1)).float().mean()
        log(f'model {name} gate {"fused " if on else "module"} vs float32 '
            f'module gates: max |diff| / max |logit| = {e.max().item():.3g}, '
            f'mean {e.mean().item():.3g}, argmax agreement '
            f'{agree.item():.6f} (max |logit| {scale:.3g})')
    assert err['float32', True].max().item() <= MODEL_TOL_F32
    for stat in (torch.max, torch.mean):
        assert (stat(err['bfloat16', True]).item()
                <= MODEL_TOL_BF16 * stat(err['bfloat16', False]).item())

    model.dtype = torch.bfloat16
    times = {}
    with torch.no_grad():
        for on in (True, False, True, False):
            set_fused(model, on)
            times.setdefault(on, []).append(
                time_ms(lambda: model(x), reps=10))
    set_fused(model, True)
    for on in (True, False):
        log(f'TIME model forward bf16 b{BATCH} {IMG}^2 fused gate '
            f'{"on " if on else "off"}: '
            + ', '.join(f'{t:.3f}' for t in times[on]) + f' ms  [{card}]')
    return model, x


# ---------------------------------------------------------------- conv3x3

def bf16_step(a, b):
    """One bf16 step (unit in the last place) at the larger magnitude of
    a and b, elementwise: for |v| in [2^(e-1), 2^e) it is 2^(e-8)."""
    import torch
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    return torch.ldexp(torch.ones_like(a), e - 8)


def within_one_step(got, want):
    """(holds, share of elements that differ, max |got - want|, elements
    beyond one bf16 step) for two bf16 tensors compared in f32: each
    element within one bf16 step of the larger value plus CONV_BF16_ATOL
    times the largest |want|."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    step = bf16_step(g, w)
    atol = CONV_BF16_ATOL * w.abs().max()
    return (bool((d <= step + atol).all()),
            (d > 0).float().mean().item(), d.max().item(),
            int((d > step).sum()))


def capture_convs(model, x):
    """The input of every 3x3 conv of one forward of model on x, with the
    conv and the BatchNorm that follows it in its DoubleConv:
    [(name, conv, bn, input)], inputs in channels_last."""
    import torch
    from unet_tpu_torch.models.layers import Conv2d
    mods = dict(model.named_modules())
    found, handles = [], []
    for name, m in model.named_modules():
        if isinstance(m, Conv2d) and m.kernel_size == (3, 3):
            parent, idx = name.rsplit('.', 1)
            bn = mods[parent][int(idx) + 1]

            def hook(mod, inputs, name=name, bn=bn):
                found.append((name, mod, bn, inputs[0].detach().contiguous(
                    memory_format=torch.channels_last)))
            handles.append(m.register_forward_pre_hook(hook))
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in handles:
            h.remove()
    return found


def conv_bound(n, h, w, cin, cout, itemsize=2, passes=1):
    """Least time for ``passes`` convs of this shape in bf16: input,
    output and weights moved once each, or 2*9*Cin*Cout flops per output
    pixel at the tensor cores' peak; returns (ms, bytes, flops)."""
    nbytes = passes * (n * h * w * (cin + cout) + 9 * cin * cout) * itemsize
    flops = passes * 2 * 9 * cin * cout * n * h * w
    return (max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS['bfloat16'])
            * 1e3, nbytes, flops)


def check_conv_edges():
    """The conv kernel on CONV_EDGE_SHAPES, seeded normal inputs: forward,
    data gradient and the fused affine + ReLU epilogue in bf16 (one bf16
    step, ``within_one_step``), and forward and epilogue in f32
    (CONV_F32_TOL), each against the plain version. Not counted."""
    import torch
    from unet_tpu_torch.ops import conv3x3 as cv
    cl = torch.channels_last
    gen = torch.Generator(device=DEVICE).manual_seed(17)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=DEVICE) * scale

    for n, h, w, cin, cout in CONV_EDGE_SHAPES:
        k = rnd(3, 3, cin, cout, scale=(9 * cin) ** -0.5)
        mul, add = 1.0 + 0.1 * rnd(cout), 0.1 * rnd(cout)
        xf = rnd(n, cin, h, w).contiguous(memory_format=cl)
        up = rnd(n, cout, h, w).contiguous(memory_format=cl)
        assert cv.igemm_shapes_supported(tuple(xf.shape), tuple(k.shape))
        xb = xf.to(torch.bfloat16).requires_grad_(True)
        y = cv.conv3x3(xb, k)
        y.backward(up.to(torch.bfloat16))
        with torch.no_grad():
            checks = {
                'forward': (y, cv.conv3x3_plain(xb, k)),
                'dx': (xb.grad, cv.conv3x3_plain(
                    up.to(torch.bfloat16), k.flip(0, 1).transpose(2, 3))),
                'epilogue': (cv.conv3x3_bn_relu(xb, k, mul, add),
                             cv.conv3x3_plain(xb, k, mul, add, True))}
            sync()
            held = {}
            for name, (got, want) in checks.items():
                assert got.shape == want.shape and got.dtype == want.dtype
                ok, share, err, beyond = within_one_step(got, want)
                held[name] = (f'{name} held {ok} ({share:.4%} differ, '
                              f'{beyond} beyond one step, max {err:.3g})')
                assert ok, (n, h, w, cin, cout, name, err)
            got32 = cv.conv3x3(xf, k)
            want32 = cv.conv3x3_plain(xf, k)
            ep32 = cv.conv3x3_bn_relu(xf, k, mul, add)
            wep32 = cv.conv3x3_plain(xf, k, mul, add, True)
            err32 = max((got32 - want32).abs().max().item(),
                        (ep32 - wep32).abs().max().item())
            torch.testing.assert_close(got32, want32, **CONV_F32_TOL)
            torch.testing.assert_close(ep32, wep32, **CONV_F32_TOL)
        log(f'conv3x3 edge shape n={n} {h}x{w} {cin}->{cout}: bf16 '
            + '; '.join(held.values())
            + f'; f32 forward and epilogue max |kernel - plain| {err32:.3g}')


def check_convs(model, x, card):
    """The conv kernel at every 3x3 conv of AttentionUNet-64 with Cin and
    Cout >= 64, on the calibrated model's own weights and activations at
    BATCH x IMG^2 bf16: the counted run (forward at BATCH, data gradient
    at CONV_BATCH_BWD), then each against its plain version, the epilogue
    against the module route, and times."""
    import torch
    import torch.nn.functional as F
    from unet_tpu_torch.ops import conv3x3 as cv
    cl = torch.channels_last
    found = capture_convs(model, x)
    convs = [c for c in found if c[1].in_channels >= 64]
    stems = [c for c in found if c[1].in_channels < 64]
    assert len(convs) == N_CONVS and len(stems) == 1, (len(convs),
                                                       len(stems))
    for _, conv, _, inp in stems:
        assert not cv.igemm_shapes_supported(
            tuple(inp.shape), (3, 3, conv.in_channels, conv.out_channels))
    ks = [conv.weight.detach().permute(2, 3, 1, 0).contiguous()
          for _, conv, _, _ in convs]  # (3, 3, Cin, Cout) float32
    for (_, _, _, inp), k in zip(convs, ks):
        assert cv.igemm_shapes_supported(tuple(inp.shape), tuple(k.shape))
    log(f'conv3x3: the guard takes all {N_CONVS} convs of AttentionUNet-'
        f'{BASE} with Cin, Cout >= 64 and refuses the 1->{BASE} stem: '
        + ', '.join(f'{inp.shape[2]}^2 {c.in_channels}->{c.out_channels}'
                    for _, c, _, inp in convs))

    # graphs for the data gradient at the training microbatch, built
    # before the counted run
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    bwd = []
    for (_, _, _, inp), k in zip(convs, ks):
        xb = inp[:CONV_BATCH_BWD].clone().requires_grad_(True)
        kb = k.clone().requires_grad_(True)
        y = cv.conv3x3(xb, kb)
        up = torch.randn(y.shape, generator=gen, device=DEVICE).to(
            y.dtype).contiguous(memory_format=cl)
        bwd.append((xb, kb, y, up))
    sync()

    # the counted run: one forward of each conv at BATCH, then the data
    # gradient of each at CONV_BATCH_BWD
    cv.launch_count = 0
    with torch.no_grad():
        outs = [cv.conv3x3(inp, k) for (_, _, _, inp), k in zip(convs, ks)]
    sync()
    fwd_launches = cv.launch_count
    for xb, kb, y, up in bwd:
        y.backward(up)
    sync()
    launches = cv.launch_count
    log(f'conv3x3: {fwd_launches} kernel launches for the {N_CONVS} '
        f'forwards (b{BATCH}), {launches - fwd_launches} for their data '
        f'gradients (b{CONV_BATCH_BWD})')
    assert fwd_launches == N_CONVS and launches == 2 * N_CONVS, (
        fwd_launches, launches)

    # each against its plain version, the epilogue against the module
    # route, the weight gradient against F.conv2d's autograd (uncounted)
    max_err = 0.0
    for (name, conv, bn, inp), k, out, (xb, kb, _, up) in zip(convs, ks,
                                                              outs, bwd):
        with torch.no_grad():
            ok, share, err, beyond = within_one_step(
                out, cv.conv3x3_plain(inp, k))
            max_err = max(max_err, err)
            xf = inp.float()
            got32 = cv.conv3x3(xf, k)
            want32 = cv.conv3x3_plain(xf, k)
            err32 = (got32 - want32).abs().max().item()
            torch.testing.assert_close(got32, want32, **CONV_F32_TOL)
            del got32, want32
            mul, add = cv.fold_bn_scale_shift(bn.weight, bn.bias,
                                              bn.running_mean,
                                              bn.running_var, bn.eps)
            fused = cv.conv3x3_bn_relu(inp, k, mul, add).float()
            module = torch.relu(bn(conv(inp))).float()
            ref = torch.relu(bn(conv(xf))).float()
            scale = ref.abs().max().item()
            e_fused = (fused - ref).abs() / scale
            e_module = (module - ref).abs() / scale
            del fused, module, ref, xf
        kt = k.flip(0, 1).transpose(2, 3)
        dx_ok, dx_share, dx_err, dx_beyond = within_one_step(
            xb.grad, cv.conv3x3_plain(up, kt))
        x32 = inp[:CONV_BATCH_BWD].float().requires_grad_(True)
        k32 = k.clone().requires_grad_(True)
        cv.conv3x3(x32, k32).backward(up.float())
        kr = k.clone().requires_grad_(True)
        F.conv2d(inp[:CONV_BATCH_BWD].float(), kr.permute(3, 2, 0, 1),
                 padding=1).backward(up.float())
        dk_err = ((k32.grad - kr.grad).abs().max()
                  / kr.grad.abs().max()).item()
        log(f'conv3x3 {name} {inp.shape[2]}^2 {conv.in_channels}->'
            f'{conv.out_channels}: bf16 held {ok} ({share:.4%} of elements '
            f'differ, {beyond} by more than one bf16 step, max |kernel - '
            f'plain| {err:.3g}); f32 max |kernel - plain| {err32:.3g}; '
            f'epilogue vs f32 module route max/mean '
            f'{e_fused.max().item():.3g}/{e_fused.mean().item():.3g} (bf16 '
            f'module route {e_module.max().item():.3g}/'
            f'{e_module.mean().item():.3g}); dx held {dx_ok} '
            f'({dx_share:.4%} differ, {dx_beyond} beyond one step, max '
            f'{dx_err:.3g}); f32 dk max |diff| / max |dk| {dk_err:.3g}')
        assert ok and dx_ok, name
        assert dk_err <= CONV_DK_TOL, name
        for stat in (torch.max, torch.mean):
            assert (stat(e_fused).item()
                    <= CONV_EPILOGUE_TOL * stat(e_module).item()), name
        del x32, k32, kr
    del outs, bwd

    # times: each conv at BATCH (forward), and the fwd + dx pair at
    # CONV_BATCH_BWD, kernel / plain / library (cuDNN), L2 flushed
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=DEVICE)
    total = {'ms': 0.0, 'plain_ms': 0.0, 'library_ms': 0.0, 'bound_ms': 0.0,
             'bytes': 0, 'flops': 0}
    pair = dict(total)
    for (name, conv, _, inp), k in zip(convs, ks):
        n, cin, h, w = inp.shape
        cout = k.shape[3]
        # weights cast once, outside the timed calls; cuDNN gets them in
        # channels_last, its own preferred layout (conv3x3_reference's
        # F.conv2d call)
        kb = k.to(torch.bfloat16)
        ktb = k.flip(0, 1).transpose(2, 3).to(torch.bfloat16).contiguous()
        wcl = conv.weight.detach().to(torch.bfloat16).contiguous(
            memory_format=cl)
        with torch.no_grad():
            t_k1 = time_ms(lambda: cv.conv3x3(inp, kb), 5, flush)
            t_p = time_ms(lambda: cv.conv3x3_plain(inp, kb), 2, flush)
            t_l = time_ms(lambda: F.conv2d(inp, wcl, padding=1), 5, flush)
            t_k2 = time_ms(lambda: cv.conv3x3(inp, kb), 5, flush)
            t_k = (t_k1 + t_k2) / 2
            x4 = inp[:CONV_BATCH_BWD]
            g4 = torch.randn(CONV_BATCH_BWD, cout, h, w, device=DEVICE).to(
                torch.bfloat16).contiguous(memory_format=cl)
            p_k = time_ms(lambda: (cv.conv3x3(x4, kb), cv.conv3x3(g4, ktb)),
                          5, flush)
            p_p = time_ms(lambda: (cv.conv3x3_plain(x4, kb),
                                   cv.conv3x3_plain(g4, ktb)), 2, flush)
            p_l = time_ms(lambda: (F.conv2d(x4, wcl, padding=1),
                                   torch.nn.grad.conv2d_input(
                                       x4.shape, wcl, g4, padding=1)),
                          5, flush)
        bound, nbytes, flops = conv_bound(n, h, w, cin, cout)
        pbound, pbytes, pflops = conv_bound(CONV_BATCH_BWD, h, w, cin, cout,
                                            passes=2)
        log(f'TIME conv3x3 {name} b{n} {h}^2 {cin}->{cout} bf16: kernel '
            f'{t_k:.4f} ms ({t_k1:.4f} / {t_k2:.4f} around the others), '
            f'plain {t_p:.4f} ms, cuDNN {t_l:.4f} ms, bound '
            f'{bound:.4f} ms ({nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} '
            f'GFLOP; {flops / t_k / 1e9:.1f} TFLOP/s, roofline share '
            f'{bound / t_k:.1%}); fwd+dx b{CONV_BATCH_BWD}: kernel '
            f'{p_k:.4f} ms, plain {p_p:.4f} ms, cuDNN {p_l:.4f} ms, bound '
            f'{pbound:.4f} ms  [{card}]')
        for acc, vals in ((total, (t_k, t_p, t_l, bound, nbytes, flops)),
                          (pair, (p_k, p_p, p_l, pbound, pbytes, pflops))):
            for key, v in zip(('ms', 'plain_ms', 'library_ms', 'bound_ms',
                               'bytes', 'flops'), vals):
                acc[key] += v
    del flush
    for label, acc in ((f'forward b{BATCH}', total),
                       (f'fwd+dx b{CONV_BATCH_BWD}', pair)):
        t_bytes = acc['bytes'] / HBM_BYTES_PER_S * 1e3
        t_ops = acc['flops'] / PEAK_FLOPS['bfloat16'] * 1e3
        acc['bound_by'] = 'bytes' if t_bytes >= t_ops else 'operations'
        log(f'TIME conv3x3 all {N_CONVS} convs, {label} bf16: kernel '
            f'{acc["ms"]:.3f} ms, plain {acc["plain_ms"]:.3f} ms, cuDNN '
            f'{acc["library_ms"]:.3f} ms, bound {acc["bound_ms"]:.3f} ms '
            f'(sum of per-conv bounds; {acc["bytes"] / 1e9:.2f} GB over '
            f'{t_bytes:.3f} ms, {acc["flops"] / 1e12:.2f} TFLOP over '
            f'{t_ops:.3f} ms), roofline share '
            f'{acc["bound_ms"] / acc["ms"]:.1%}  [{card}]')
    rate = total['flops'] / total['ms'] / 1e9
    log(f'TIME conv3x3 forward b{BATCH}: {rate:.1f} TFLOP/s over the '
        f'{N_CONVS} convs; the earlier design took {PREV_MS["conv3x3"]} ms  '
        f'[{card}]')
    total.update(launches=launches, max_abs_err=max_err)
    return total


# ---------------------------------------------------------------- serve

def _request(addr, method, path, body=None):
    conn = http.client.HTTPConnection(*addr, timeout=300)
    try:
        conn.request(method, path, body=body)
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        conn.close()


def _png(arr):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format='PNG')
    return buf.getvalue()


def _image(rng, h, w):
    """A smooth random slice (low-frequency noise upsampled), uint8."""
    from PIL import Image
    small = (rng.random((max(2, h // 32), max(2, w // 32))) * 255)
    return np.asarray(Image.fromarray(small.astype(np.uint8)).resize(
        (w, h), Image.BILINEAR))


def serve_main_path(model, card):
    """The main path: create_server on the card, concurrent clients."""
    import torch
    from PIL import Image
    from unet_tpu_torch.cli.predict import preprocess_image
    from unet_tpu_torch.cli.serve import create_server
    from unet_tpu_torch.data.cache import _native_lib
    from unet_tpu_torch.ops import attention_gate as ag
    from unet_tpu_torch.ops.bitpack import unpack_masks_host
    from unet_tpu_torch.train.trainer import (make_predict_step_u8,
                                              make_serve_masks_step)

    cfg = {'model': {'type': 'attention_unet', 'n_channels': 1,
                     'n_classes': 2, 'bilinear': True,
                     'base_features': BASE, 'deep_supervision': False},
           'tpu': {'compute_dtype': 'bfloat16',
                   'fused_attention_gate': True}}
    rng = np.random.default_rng(3)
    with tempfile.TemporaryDirectory() as tmp:
        path = f'{tmp}/attention_unet64.pt'
        torch.save({'epoch': 0, 'config': cfg, 'metrics': {},
                    'model_state_dict': {k: v.detach().cpu() for k, v in
                                         model.state_dict().items()}}, path)
        t0 = time.perf_counter()
        server, batcher = create_server(path, img_size=IMG, threshold=0.5,
                                        max_batch=BATCH, port=0,
                                        device=DEVICE)
        log(f'serve: create_server (load + warm-up, kernels built) '
            f'{time.perf_counter() - t0:.2f} s')
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    addr = server.server_address[:2]
    try:
        # 1. one request alone: the served mask equals the same pipeline
        #    run by hand (the batch is 8 copies either way)
        img = _image(rng, 400, 300)
        body = _png(img)
        status, headers, data = _request(addr, 'POST', '/predict', body)
        assert status == 200, data
        served = np.asarray(Image.open(io.BytesIO(data)))
        assert served.shape == img.shape
        x8, orig = preprocess_image(io.BytesIO(body), IMG)
        u8 = torch.from_numpy(np.repeat(x8[None], BATCH, 0)).to(DEVICE)
        thr = torch.full((BATCH,), 0.5, device=DEVICE)
        packed = make_serve_masks_step(model)(u8, thr).cpu().numpy()
        prob = make_predict_step_u8(model)(u8)[0, 1].cpu().numpy()
        want = Image.fromarray(unpack_masks_host(packed[0], IMG) * 255)
        want = np.asarray(want.resize(orig, Image.NEAREST))
        near = Image.fromarray((np.abs(prob - 0.5) < 1e-3).astype(np.uint8))
        near = np.asarray(near.resize(orig, Image.NEAREST)) > 0
        differ = served != want
        log(f'serve: reference request {img.shape}: '
            f'{int((served > 0).sum())} tumor px, {int(differ.sum())} px '
            f'differ from the direct pipeline ({int(near.sum())} px within '
            f'1e-3 of the threshold)')
        assert not (differ & ~near).any()
        assert 0 < (served > 0).mean() < 1

        # 2. the main path's run: concurrent clients, images of various
        #    sizes, PNG and JSON responses
        before = json.loads(_request(addr, 'GET', '/metrics')[2])
        bodies = [(s, _png(_image(rng, *s))) for s in SERVE_SIZES]
        latencies, failures = [], []
        lock = threading.Lock()

        def client(c):
            for r in range(REQUESTS_PER_CLIENT):
                (h, w), b = bodies[(c + r) % len(bodies)]
                fmt = 'json' if (c + r) % 2 else 'png'
                t = time.perf_counter()
                st, hd, dt = _request(addr, 'POST',
                                      f'/predict?format={fmt}', b)
                lat = time.perf_counter() - t
                try:
                    assert st == 200, (st, dt[:200])
                    if fmt == 'json':
                        rec = json.loads(dt)
                        assert (rec['height'], rec['width']) == (h, w), rec
                    else:
                        m = np.asarray(Image.open(io.BytesIO(dt)))
                        assert m.shape == (h, w), m.shape
                        assert int(hd['X-Tumor-Pixels']) == int(
                            (m > 127).sum())
                except AssertionError as e:
                    with lock:
                        failures.append(repr(e))
                with lock:
                    latencies.append(lat)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(CLIENTS)]
        ag.launch_count = 0
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
            assert not t.is_alive(), 'client hung'
        wall = time.perf_counter() - t0
        assert not failures, failures[:3]
        launches = ag.launch_count

        n = CLIENTS * REQUESTS_PER_CLIENT
        metrics = json.loads(_request(addr, 'GET', '/metrics')[2])
        b = metrics['batcher']
        assert metrics['requests_total'] == n + 1, metrics
        assert metrics['request_errors_total'] == 0, metrics
        assert b['rows_real'] == n + 1 and b['errors'] == 0, b
        assert sum(b['fill']) == b['dispatches']
        dispatches = b['dispatches'] - before['batcher']['dispatches']
        assert launches == 4 * dispatches, (launches, dispatches)
        lat = sorted(latencies)
        p50 = statistics.median(lat) * 1e3
        p90 = lat[int(0.9 * (len(lat) - 1))] * 1e3
        native = _native_lib() is not None
        log(f'serve: {n} requests from {CLIENTS} clients answered, '
            f'{dispatches} dispatches, {launches} gate kernel launches '
            f'(mean fill over the server\'s life {b["mean_fill"]:.2f}); '
            f'PNG decode: '
            f'{"native csrc/libslicecache.so" if native else "PIL fallback"}')
        log(f'TIME serve {n / wall:.2f} slices/s, p50 {p50:.1f} ms, '
            f'p90 {p90:.1f} ms, mean device step {b["mean_device_ms"]:.2f} '
            f'ms at {CLIENTS} concurrent clients, batch {BATCH}, {IMG}^2  '
            f'[{card}]')
        return launches
    finally:
        server.shutdown()
        batcher.close()
        server.server_close()


# ---------------------------------------------------------------- predict

PREDICT_SIZES = [(512, 512), (400, 300), (256, 256), (600, 520), (512, 384),
                 (333, 517), (128, 200), (700, 700), (128, 128), (640, 480)]
PREDICT_IMAGES = 40
PREDICT_THRESHOLDS = (0.3, 0.5, 0.7)


def predict_path(model, card):
    """The directory predict CLI on the card: PREDICT_IMAGES synthetic
    PNGs of mixed sizes plus one corrupt file, a .pt whose config turns
    the fused gate on, a threshold sweep and overlays. Every mask and
    sweep file is written, the corrupt file skipped, the masks equal the
    direct pipeline except pixels within 1e-3 of a threshold, and the gate
    kernel runs 4 times per chunk dispatched."""
    import torch
    from PIL import Image
    from unet_tpu_torch.cli import predict as predict_cli
    from unet_tpu_torch.ops import attention_gate as ag
    from unet_tpu_torch.ops.bitpack import unpack_masks_host
    from unet_tpu_torch.train.trainer import (make_predict_masks_step,
                                              make_predict_step_u8)

    cfg = {'model': {'type': 'attention_unet', 'n_channels': 1,
                     'n_classes': 2, 'bilinear': True,
                     'base_features': BASE, 'deep_supervision': False},
           'tpu': {'compute_dtype': 'bfloat16',
                   'fused_attention_gate': True}}
    rng = np.random.default_rng(13)
    with tempfile.TemporaryDirectory() as tmp:
        pt = f'{tmp}/attention_unet64.pt'
        _save_pt(model, cfg, pt)
        src = f'{tmp}/slices'
        out = f'{tmp}/predictions'
        os.makedirs(src)
        stems = []
        for i in range(PREDICT_IMAGES):
            h, w = PREDICT_SIZES[i % len(PREDICT_SIZES)]
            stems.append(f'slice_{i:03d}')
            Image.fromarray(_image(rng, h, w)).save(f'{src}/{stems[-1]}.png')
        # sorted between slice_017 and slice_018: its chunk is padded
        with open(f'{src}/slice_017_corrupt.png', 'wb') as f:
            f.write(b'\x89PNG\r\n\x1a\nnot a real png')
        argv = ['--weights', pt, '--source', src, '--output', out,
                '--img-size', str(IMG), '--batch-size', str(BATCH),
                '--threshold', ','.join(map(str, PREDICT_THRESHOLDS)),
                '--save-overlay']
        if DEVICE == 'cpu':
            argv += ['--device', 'cpu']
        ag.launch_count = 0
        summary = predict_cli.main(argv)
        launches = ag.launch_count
        chunks = summary['chunks']
        log(f'predict: {summary["processed"]}/{summary["files"]} images in '
            f'{chunks} chunks, skipped {summary["skipped"]}, {launches} gate '
            f'kernel launches')
        assert launches == 4 * chunks, (launches, chunks)
        assert chunks == -(-(PREDICT_IMAGES + 1) // BATCH)
        assert summary['processed'] == PREDICT_IMAGES
        assert [os.path.basename(p) for p in summary['skipped']] == [
            'slice_017_corrupt.png']
        want = {f'{s}{suffix}' for s in stems for suffix in
                ['_mask.png', '_overlay.png']
                + [f'_mask_t{t:g}.png' for t in PREDICT_THRESHOLDS[1:]]}
        assert set(os.listdir(out)) == want, sorted(
            set(os.listdir(out)) ^ want)[:5]

        # the direct pipeline on the same weights and the same chunks as
        # the CLI (files in order, the corrupt one dropped, the tail
        # padded by repeating its last image)
        loaded, _ = predict_cli.load_model(pt, device=DEVICE)
        masks_step = make_predict_masks_step(loaded)
        prob_step = make_predict_step_u8(loaded)
        thr = torch.tensor(PREDICT_THRESHOLDS, device=DEVICE)
        suffixes = ['_mask.png'] + [f'_mask_t{t:g}.png'
                                    for t in PREDICT_THRESHOLDS[1:]]
        files = [f for f in predict_cli.gather_sources(src)]
        n_differ = n_near = 0
        rerun = None
        for start in range(0, len(files), BATCH):
            chunk = [f for f in files[start:start + BATCH]
                     if 'corrupt' not in f.name]
            dec = [predict_cli.preprocess_image(f, IMG) for f in chunk]
            xs = [d[0] for d in dec]
            xs += [xs[-1]] * (BATCH - len(xs))
            u8 = torch.from_numpy(np.stack(xs)).to(DEVICE)
            packed = masks_step(u8, thr).cpu().numpy()
            probs = prob_step(u8)[:, 1].float()
            if rerun is None:  # is the forward deterministic?
                rerun = (prob_step(u8)[:, 1].float() - probs).abs().max()
            probs = probs.cpu().numpy()
            for i, (f, (_, orig)) in enumerate(zip(chunk, dec)):
                for t, (suffix, t_val) in enumerate(zip(suffixes,
                                                        PREDICT_THRESHOLDS)):
                    direct = predict_cli.restore_mask(
                        unpack_masks_host(packed[t, i], IMG)
                        * np.uint8(255), orig)
                    got = np.asarray(Image.open(f'{out}/{f.stem}{suffix}'))
                    gap = np.abs(probs[i] - t_val)
                    near = np.asarray(Image.fromarray(
                        (gap < 1e-3).astype(np.uint8)).resize(
                            orig, Image.NEAREST)) > 0
                    differ = got != direct
                    n_differ += int(differ.sum())
                    n_near += int(near.sum())
                    if (differ & ~near).any():
                        log(f'predict: {f.name}{suffix}: '
                            f'{int((differ & ~near).sum())} px differ away '
                            f'from the threshold; the same forward run '
                            f'twice differs by {rerun.item():.3g} in '
                            f'probability')
                    assert not (differ & ~near).any(), (f.name, suffix)
        log(f'predict: masks of all {len(suffixes)} thresholds equal the '
            f'direct pipeline on the same chunks except {n_differ} px, all '
            f'within 1e-3 of the threshold ({n_near} px are); the same '
            f'forward run twice differs by {rerun.item():.3g} in '
            f'probability')
    st = summary['stage_seconds']
    log(f'TIME predict {summary["processed"]} slices of mixed sizes at '
        f'{IMG}^2, batch {BATCH}, {len(PREDICT_THRESHOLDS)} thresholds, '
        f'overlays: {summary["slices_per_s"]:.2f} slices/s end to end, '
        f'{summary["steady_slices_per_s"]:.2f} slices/s after the first '
        f'chunk; stage seconds ' + ', '.join(f'{k} {v:.2f}'
                                             for k, v in st.items())
        + f'  [{card}]')
    return launches


# ---------------------------------------------------------------- replicas

# the replicas phase: concurrent requests (half the serve phase's), PNGs
# through the predict CLI (whole chunks), requests sent one at a time
REPLICA_REQUESTS = 64
REPLICA_IMAGES = 16
REPLICA_SOLO = 8
SPATIAL_BANDS = 4
SPATIAL_F32_ATOL = 1e-4


def _device0():
    import torch
    return torch.device(DEVICE, 0) if DEVICE == 'cuda' else torch.device(DEVICE)


def _replica_lists():
    """Replica lists of the multi-device phases: two replicas of the
    first device, and every GPU where there are several (and BATCH
    splits over them)."""
    import torch
    from unet_tpu_torch.core.mesh import inference_devices
    lists = {'2 replicas of one device': [_device0()] * 2}
    n = torch.cuda.device_count() if DEVICE == 'cuda' else 1
    if n > 1 and BATCH % n == 0:
        lists[f'{n} GPUs'] = inference_devices('cuda')
    return lists


def _by_stream(x, band):
    """A replica's key: its device and stream."""
    import torch
    return (str(x.device),
            torch.cuda.current_stream(x.device).cuda_stream if x.is_cuda
            else 0)


def _by_band(x, band):
    """A band's key: its device and its first row as a share of the map's
    height (the same at every level for bands on multiples of 16); a
    whole map's is 'whole'."""
    return (str(x.device),
            'whole' if band is None else band.y_off / band.h_out_full)


class _GateTally:
    """Counts the gate kernel's launches by ``key(x, band)``: by (device,
    stream) for replicas, each enqueuing on a stream of its own, or by
    (device, band). Wraps the models' reference to the wrapper; the
    wrapper's own count moves where a kernel launches."""

    def __init__(self, key=_by_stream):
        from unet_tpu_torch.models import layers
        from unet_tpu_torch.ops import attention_gate as ag
        self.counts = {}
        self._layers, self._orig = layers, layers.attention_gate_fused

        def counting(g, x, *args):
            before = ag.launch_count
            out = self._orig(g, x, *args)
            if ag.launch_count > before or DEVICE == 'cpu':
                k = key(x, args[5] if len(args) > 5 else None)
                self.counts[k] = self.counts.get(k, 0) + 1
            return out

        layers.attention_gate_fused = counting

    def close(self):
        self._layers.attention_gate_fused = self._orig


def _peaks(devices):
    """Peak allocated GiB of each distinct CUDA device of ``devices``
    since the last reset (empty on the CPU)."""
    import torch
    return [round(torch.cuda.max_memory_allocated(d) / 2 ** 30, 2)
            for d in sorted(set(devices), key=str) if d.type == 'cuda']


def _serve_on(path, devices, bodies, solo=(), max_batch=None):
    """``create_server`` on ``devices`` (batch ``max_batch``, default
    BATCH) answering ``bodies`` (PNG requests) from CLIENTS concurrent
    clients, then ``solo`` one at a time: /healthz, the concurrent
    traffic's response bodies, dispatches and gate launches per replica
    (each replica's stream), slices/s and p50 (host clock, load and
    warm-up excluded), the mean device step, the peak memory per device,
    and the solo responses."""
    import torch
    from unet_tpu_torch.cli.serve import create_server
    for d in set(devices):
        if d.type == 'cuda':
            torch.cuda.reset_peak_memory_stats(d)
    server, batcher = create_server(path, img_size=IMG, threshold=0.5,
                                    max_batch=max_batch or BATCH, port=0,
                                    devices=devices)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    addr = server.server_address[:2]
    tally = _GateTally()
    try:
        health = json.loads(_request(addr, 'GET', '/healthz')[2])
        out = [None] * len(bodies)
        latencies = [0.0] * len(bodies)

        def client(c):
            for i in range(c, len(bodies), CLIENTS):
                t = time.perf_counter()
                st, _, data = _request(addr, 'POST', '/predict', bodies[i])
                latencies[i] = time.perf_counter() - t
                out[i] = data if st == 200 else None

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
            assert not t.is_alive(), 'client hung'
        wall = time.perf_counter() - t0
        b = json.loads(_request(addr, 'GET', '/metrics')[2])['batcher']
        launches = sorted(tally.counts.values())
        solo_out = [_request(addr, 'POST', '/predict', body)[2]
                    for body in solo]
        return {'health': health, 'bodies': out,
                'dispatches': b['dispatches'], 'launches': launches,
                'slices_per_s': len(bodies) / wall,
                'p50_ms': (statistics.median(latencies) * 1e3 if bodies
                           else None),
                'device_ms': b.get('mean_device_ms'),
                'peak_gib': _peaks(devices), 'solo': solo_out}
    finally:
        tally.close()
        server.shutdown()
        batcher.close()
        server.server_close()


def _predict_on(pt, src, out, devices, *extra):
    """The predict CLI's directory pipeline on ``devices``: its summary,
    the gate launches per replica, and what it printed about sharding."""
    from unet_tpu_torch.cli import predict as predict_cli
    args = predict_cli.parse_args([
        '--weights', pt, '--source', src, '--output', out, '--img-size',
        str(IMG), '--batch-size', str(BATCH), '--threshold',
        ','.join(map(str, PREDICT_THRESHOLDS)), *extra])
    tally = _GateTally()
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            summary = predict_cli.run_directory(args, devices)
    finally:
        tally.close()
    said = [line for line in buf.getvalue().splitlines()
            if line.startswith('Sharding')]
    return summary, sorted(tally.counts.values()), said


def _same_files(a, b):
    """(names, names whose bytes differ) of two output directories."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    return names, [n for n in names if open(f'{a}/{n}', 'rb').read()
                   != open(f'{b}/{n}', 'rb').read()]


def _batch_effects(model, rows):
    """bf16 logits of ``rows`` (one batch) on one device against the same
    rows as two blocks of half the rows, and against the rows in another
    order: (share of logits that differ, max |difference|) each. cuDNN's
    bf16 algorithms depend on the batch size and a row's result on its
    position in the batch."""
    import torch
    half = rows.shape[0] // 2
    perm = torch.arange(rows.shape[0], device=rows.device).roll(1)
    with torch.inference_mode():
        whole = model(rows)
        blocks = torch.cat([model(rows[:half]), model(rows[half:])])
        moved = model(rows[perm])[perm.argsort()]
    return [((whole - t).abs() > 0).float().mean().item()
            for t in (blocks, moved)], [
                (whole - t).abs().max().item() for t in (blocks, moved)]


def replicas_path(model, card):
    """Data-parallel inference in one process (``core/mesh.py``) on k
    replicas: two of the first device, and every GPU where there are
    several. A row's bf16 result depends on the batch size and on its
    position in the batch (``_batch_effects``), so each comparison puts
    the same rows at the same places: (1) ``ReplicaSet.run`` on a batch
    equals the one-device step on its k blocks of rows bit for bit, ten
    runs, the gate kernel launching 4 times per forward on each replica;
    (2) ``create_server`` on the replicas answers the serve phase's kind
    of traffic from CLIENTS clients (``/healthz`` says ``data_parallel``
    k, 4 gate launches per dispatch on each replica; slices/s, p50 and
    peak memory beside one device), then requests sent one at a time (each
    alone in its dispatch) get the masks of the one-device server at batch
    BATCH / k bit for bit; (3) the predict CLI's directory pipeline on the
    replicas writes the PNGs of the one-device run at batch BATCH / k
    byte for byte (the same chunks, split in k)."""
    import torch
    from PIL import Image
    from unet_tpu_torch.core.mesh import ReplicaSet
    from unet_tpu_torch.train.trainer import make_serve_masks_step
    cfg = {'model': {'type': 'attention_unet', 'n_channels': 1,
                     'n_classes': 2, 'bilinear': True,
                     'base_features': BASE, 'deep_supervision': False},
           'tpu': {'compute_dtype': 'bfloat16',
                   'fused_attention_gate': True}}
    dev0 = _device0()
    rng = np.random.default_rng(3)
    n = REPLICA_REQUESTS
    bodies = [_png(_image(rng, *SERVE_SIZES[i % len(SERVE_SIZES)]))
              for i in range(n)]
    solo = bodies[:REPLICA_SOLO]
    u8 = torch.from_numpy(np.stack([_image(rng, IMG, IMG)
                                    for _ in range(BATCH)])[:, None])
    thr = torch.linspace(0.3, 0.7, BATCH)
    shares, maxes = _batch_effects(
        model, (u8.to(dev0).float() / 255.0 - 0.5) / 0.5)
    log(f'replicas: bf16 logits of {BATCH} rows as one batch on one device '
        f'against two blocks of {BATCH // 2}: {shares[0]:.2%} differ, max '
        f'{maxes[0]:.3g}; against the rows in another order: '
        f'{shares[1]:.2%} differ, max {maxes[1]:.3g}')
    step = make_serve_masks_step(model)

    def report(name, r, p):
        log(f'TIME replicas: server on {name}: {r["slices_per_s"]:.2f} '
            f'slices/s, p50 {r["p50_ms"]:.1f} ms at {CLIENTS} clients, mean '
            f'device step {r["device_ms"]:.2f} ms, {r["dispatches"]} '
            f'dispatches, gate kernel launches per replica {r["launches"]}, '
            f'peak GiB per device {r["peak_gib"]}; predict CLI '
            f'{p["steady_slices_per_s"]:.2f} slices/s after the first '
            f'chunk  [{card}]')

    with tempfile.TemporaryDirectory() as tmp:
        pt = f'{tmp}/attention_unet64.pt'
        _save_pt(model, cfg, pt)
        src = f'{tmp}/slices'
        os.makedirs(src)
        for i in range(REPLICA_IMAGES):
            h, w = PREDICT_SIZES[i % len(PREDICT_SIZES)]
            Image.fromarray(_image(rng, h, w)).save(f'{src}/s_{i:03d}.png')
        one = _serve_on(pt, [dev0], bodies)
        one_p, one_launches, _ = _predict_on(pt, src, f'{tmp}/one', [dev0])
        report(f'one device at batch {BATCH}', one, one_p)
        assert one['health']['data_parallel'] == 1
        if DEVICE == 'cuda':
            assert one['launches'] == [4 * one['dispatches']]
            assert one_launches == [4 * one_p['chunks']]
        for name, devices in _replica_lists().items():
            k = len(devices)
            block = BATCH // k
            with torch.inference_mode():
                want = torch.cat([step(u8[i:i + block].to(dev0),
                                       thr[i:i + block].to(dev0)).cpu()
                                  for i in range(0, BATCH, block)])
            replicas = ReplicaSet(model, devices, make_serve_masks_step,
                                  per_row_thresholds=True)
            tally = _GateTally()
            try:
                runs = [replicas.run(u8, thr).wait() for _ in range(10)]
            finally:
                tally.close()
            run_differ = sum(not torch.equal(g, want) for g in runs)
            run_launches = sorted(tally.counts.values())
            del replicas
            base = _serve_on(pt, [dev0], [], solo, block)
            r = _serve_on(pt, devices, bodies, solo)
            p, p_launches, said = _predict_on(pt, src, f'{tmp}/rep{k}',
                                              devices)
            _predict_on(pt, src, f'{tmp}/base{k}', [dev0], '--batch-size',
                        str(block))
            names, p_differ = _same_files(f'{tmp}/base{k}', f'{tmp}/rep{k}')
            solo_differ = sum(a != b for a, b in zip(r['solo'],
                                                     base['solo']))
            report(name, r, p)
            log(f'replicas: {name}: ReplicaSet.run against the one-device '
                f'step on its {k} blocks of {block} rows: {run_differ} of 10 '
                f'runs differ, gate launches per replica {run_launches}; '
                f'server /healthz data_parallel '
                f'{r["health"]["data_parallel"]}, {n} concurrent requests '
                f'answered: {sum(b is not None for b in r["bodies"])}; '
                f'{solo_differ} of {len(solo)} requests sent alone differ '
                f'from the one-device server at batch {block}; predict CLI '
                f'said {said}, gate launches per replica {p_launches} over '
                f'{p["chunks"]} chunks, {len(p_differ)} of {len(names)} PNGs '
                f'differ from the one-device run at batch {block}')
            assert run_differ == 0 and solo_differ == 0 and not p_differ
            assert r['health']['data_parallel'] == k
            assert None not in r['bodies']
            assert said == [f'Sharding batches over {k} devices']
            assert p['processed'] == REPLICA_IMAGES
            if DEVICE == 'cuda':
                assert run_launches == [40] * k, run_launches
                assert r['launches'] == [4 * r['dispatches']] * k, r
                assert p_launches == [4 * p['chunks']] * k, p_launches


# ---------------------------------------------------------------- spatial

def spatial_path(model, card):
    """The height-sharded forward (``core/spatial.py``) at full width:
    the serve phase's AttentionUNet-64 at 512^2, batch 1 and BATCH, over
    SPATIAL_BANDS bands of the first device (and over every GPU where
    there are several), against the unsharded forward, both with the
    fused gate on: the gate kernel launches on every band, 4 times per
    forward on each (counted by device and band). float32 with TF32 off: probabilities within SPATIAL_F32_ATOL. bfloat16:
    both bf16 forwards held against the unsharded float32 one, the
    sharded one's error (max and mean) at most MODEL_TOL_BF16 times the
    unsharded one's, as the fused gate route is held: sharding adds no
    error beyond bf16's rounding; ``within_one_step`` of the two bf16
    logits is printed beside it. Then ms per forward and peak memory per
    device beside the unsharded, and ``--spatial-shard`` through the
    predict CLI."""
    import torch
    from unet_tpu_torch.core.spatial import SpatialShardedModel
    from unet_tpu_torch.ops import attention_gate as ag

    dev0 = _device0()
    lists = {f'{SPATIAL_BANDS} bands of one device':
             [dev0] * SPATIAL_BANDS}
    lists.update({k: v for k, v in _replica_lists().items() if 'GPU' in k})
    rng = np.random.default_rng(17)
    u8 = torch.from_numpy(np.stack([_image(rng, IMG, IMG)
                                    for _ in range(BATCH)])[:, None])
    x = ((u8.to(dev0).float() / 255.0 - 0.5) / 0.5)
    held = []

    def forward(m, dtype, nb):
        model.dtype = dtype
        tally = _GateTally(_by_band)
        try:
            with torch.inference_mode():
                ag.launch_count = 0
                out = m(x[:nb])
                sync()
        finally:
            tally.close()
        return out, ag.launch_count, tally.counts

    try:
        for name, devices in lists.items():
            sharded = SpatialShardedModel(model, devices)
            for nb in (1, BATCH):
                ref, ref_launches, _ = forward(model, torch.float32, nb)
                got, launches, bands = forward(sharded, torch.float32, nb)
                perr = (torch.softmax(got, 1)
                        - torch.softmax(ref, 1)).abs().max().item()
                want16, _, _ = forward(model, torch.bfloat16, nb)
                got16, launches16, bands16 = forward(sharded,
                                                     torch.bfloat16, nb)
                per_band = [bands.get(k, 0) + bands16.get(k, 0)
                            for k in sorted(set(bands) | set(bands16))]
                scale = ref.abs().max().item()
                err_u = (want16 - ref).abs() / scale
                err_s = (got16 - ref).abs() / scale
                ratio = [(stat(err_s) / stat(err_u)).item()
                         for stat in (torch.max, torch.mean)]
                step_ok, share, dmax, beyond = within_one_step(got16, want16)
                log(f'spatial: b{nb} {IMG}^2 over {name} ('
                    f'{launches + launches16} gate launches in a float32 '
                    f'and a bfloat16 forward, per band {per_band}; '
                    f'unsharded {ref_launches} per forward): float32 max '
                    f'|prob - unsharded| {perr:.3g} '
                    f'(bound {SPATIAL_F32_ATOL}); bfloat16 error against '
                    f'the float32 forward, sharded / unsharded: max '
                    f'{err_s.max().item():.3g} / {err_u.max().item():.3g}, '
                    f'mean {err_s.mean().item():.3g} / '
                    f'{err_u.mean().item():.3g} (ratios {ratio[0]:.3f}, '
                    f'{ratio[1]:.3f}; bound {MODEL_TOL_BF16}); bf16 logits '
                    f'against each other: {share:.2%} differ, max '
                    f'{dmax:.3g}, {beyond} beyond one bf16 step '
                    f'(within_one_step: {step_ok})')
                want_launches = (per_band == [8] * len(devices)
                                 and ref_launches == 4
                                 if DEVICE == 'cuda' else True)
                held.append((perr <= SPATIAL_F32_ATOL
                             and max(ratio) <= MODEL_TOL_BF16
                             and want_launches, name, nb))
            if DEVICE == 'cuda':
                model.dtype = torch.bfloat16
                _time_spatial(model, sharded, x, name, card)
            del sharded
        assert all(h[0] for h in held), [h for h in held if not h[0]]
    finally:
        model.dtype = torch.bfloat16
    _spatial_cli(model, card)


def _time_spatial(model, sharded, x, name, card):
    """ms per bf16 forward and peak memory per device, sharded and not,
    at batch 1 and BATCH."""
    import torch
    devices = sorted({d for d in sharded.devices}, key=str)
    for nb in (1, BATCH):
        row = []
        for label, m in (('unsharded', model), ('sharded', sharded)):
            for d in devices:
                torch.cuda.reset_peak_memory_stats(d)
            with torch.inference_mode():
                ms = time_ms(lambda: m(x[:nb]), reps=5)
            peaks = [torch.cuda.max_memory_allocated(d) / 2 ** 30
                     for d in devices]
            row.append(f'{label} {ms:.3f} ms, peak ' + ' / '.join(
                f'{p:.2f}' for p in peaks) + ' GiB')
        log(f'TIME spatial bf16 b{nb} {IMG}^2 over {name} (peak per device '
            f'{[str(d) for d in devices]}): ' + '; '.join(row) + f'  [{card}]')


def _spatial_cli(model, card):
    """``--spatial-shard`` through the predict CLI over SPATIAL_BANDS
    bands of the first device: it says it shards, and its masks equal the
    unsharded CLI run's except at pixels within 1e-3 of a threshold, and
    the gate kernel launches on every band. Both runs read a .pt with the
    fused gate on in float32, where the two forwards agree to
    SPATIAL_F32_ATOL; in bf16 their probabilities differ by bf16 steps,
    which the phase above holds."""
    import torch
    from PIL import Image
    from unet_tpu_torch.cli import predict as predict_cli
    from unet_tpu_torch.train.trainer import make_predict_step_u8
    cfg = {'model': {'type': 'attention_unet', 'n_channels': 1,
                     'n_classes': 2, 'bilinear': True,
                     'base_features': BASE, 'deep_supervision': False},
           'tpu': {'compute_dtype': 'float32',
                   'fused_attention_gate': True}}
    rng = np.random.default_rng(19)
    dev0 = _device0()
    with tempfile.TemporaryDirectory() as tmp:
        pt = f'{tmp}/attention_unet64.pt'
        _save_pt(model, cfg, pt)
        src = f'{tmp}/slices'
        os.makedirs(src)
        for i in range(2 * BATCH):
            h, w = PREDICT_SIZES[i % len(PREDICT_SIZES)]
            Image.fromarray(_image(rng, h, w)).save(f'{src}/s_{i:03d}.png')
        one, _, _ = _predict_on(pt, src, f'{tmp}/one', [dev0])
        t0 = time.perf_counter()
        summary, launches, said = _predict_on(pt, src, f'{tmp}/bands',
                                              [dev0] * SPATIAL_BANDS,
                                              '--spatial-shard')
        wall = time.perf_counter() - t0
        names, differ = _same_files(f'{tmp}/one', f'{tmp}/bands')
        loaded, _ = predict_cli.load_model(pt, device=dev0)
        step = make_predict_step_u8(loaded)
        suffixes = ['_mask.png'] + [f'_mask_t{t:g}.png'
                                    for t in PREDICT_THRESHOLDS[1:]]
        far = 0
        for name in differ:
            stem, suffix = name.split('_mask')[0], '_mask' + name.split(
                '_mask')[1]
            thr = PREDICT_THRESHOLDS[suffixes.index(suffix)]
            x8, orig = predict_cli.preprocess_image(f'{src}/{stem}.png', IMG)
            prob = step(torch.from_numpy(x8[None]).to(dev0))[0, 1].float()
            near = np.asarray(Image.fromarray(
                ((prob - thr).abs() < 1e-3).cpu().numpy().astype(np.uint8))
                .resize(orig, Image.NEAREST)) > 0
            a = np.asarray(Image.open(f'{tmp}/one/{name}'))
            b = np.asarray(Image.open(f'{tmp}/bands/{name}'))
            far += int(((a != b) & ~near).sum())
        log(f'spatial: predict CLI --spatial-shard over {SPATIAL_BANDS} '
            f'bands: {said}; {summary["processed"]} images in {wall:.2f} s '
            f'({summary["chunks"]} chunks, {sum(launches)} gate launches); '
            f'{len(differ)} of {len(names)} mask PNGs differ from the '
            f'unsharded run\'s, {far} px of them away from a threshold  '
            f'[{card}]')
        assert said == [f'Sharding image height over {SPATIAL_BANDS} devices']
        assert summary['processed'] == one['processed'] == 2 * BATCH
        assert far == 0
        if DEVICE == 'cuda':
            assert sum(launches) == 4 * SPATIAL_BANDS * summary['chunks']


# ---------------------------------------------------------------- train

def _save_pt(model, cfg, path):
    import torch
    torch.save({'epoch': 0, 'config': cfg, 'metrics': {},
                'model_state_dict': {k: v.detach().cpu() for k, v in
                                     model.state_dict().items()}}, path)


def one_rank_config(tmp):
    """``TRAIN_CONFIG`` with ``tpu.data_parallel: 1``, written to ``tmp``:
    the phases that count launches in this process run the train CLI
    here, and the config's -1 would spawn one rank per GPU on a host with
    several (their launches counted in other processes)."""
    import yaml
    path = f'{tmp}/one_rank.yaml'
    if not os.path.exists(path):
        cfg = _train_cfg()
        cfg.setdefault('tpu', {})['data_parallel'] = 1
        with open(path, 'w') as f:
            yaml.safe_dump(cfg, f)
    return path


def save_init(tmp):
    """The flagship model's random weights from seed 7, as a
    reference-format ``tmp/init.pt``; returns the model."""
    import torch
    from unet_tpu_torch.models import create_model
    cfg = _train_cfg()
    m = cfg['model']
    init = create_model(m['type'], n_channels=m['n_channels'],
                        n_classes=m['n_classes'], bilinear=m['bilinear'],
                        base_features=m['base_features'],
                        deep_supervision=m['deep_supervision'],
                        generator=torch.Generator().manual_seed(7))
    _save_pt(init, cfg, f'{tmp}/init.pt')
    return init


def run_train_cli(tmp, name, config_path, init_pt):
    from unet_tpu_torch.cli import train as train_cli
    argv = ['--config', config_path, '--project', tmp, '--name', name,
            '--init-weights', init_pt, *TRAIN_ARGS]
    if DEVICE == 'cpu':
        argv += ['--device', 'cpu']
    return train_cli.main(argv)


def train_main_path(card, tmp):
    """The training path: the port's train CLI on the flagship config,
    the warp kernel's launches counted around the run. Runs in ``tmp``;
    returns (launches, the augmentation-on run's directory)."""
    import torch
    import yaml
    from unet_tpu_torch.cli.predict import load_model
    from unet_tpu_torch.ops import warp
    from unet_tpu_torch.train.trainer import make_predict_step_u8
    from unet_tpu_torch.utils.config import load_config
    from unet_tpu_torch.utils.torch_port import load_torch_checkpoint

    config = one_rank_config(tmp)
    init = save_init(tmp)
    out = {}
    init_pt = f'{tmp}/init.pt'
    warp.launch_count = 0
    t0 = time.perf_counter()
    hist = run_train_cli(tmp, 'aug_on', config, init_pt)
    wall = time.perf_counter() - t0
    launches = warp.launch_count
    log(f'train: {TRAIN_CONFIG} (bf16, b4 x accum 8, augmentation on) '
        f'ran in {wall:.1f} s with {launches} warp kernel launches for '
        f'{TRAIN_SUPERBATCHES} super-batches; train loss '
        f'{hist["train_loss"]}, val loss {hist["val_loss"]}')
    assert launches == TRAIN_SUPERBATCHES, launches
    assert hist['warp_launches'] == [launches], hist['warp_launches']
    assert all(np.isfinite(hist['train_loss'] + hist['val_loss']))
    last = f'{hist["save_dir"]}/weights/last/model.pt'
    before = init.state_dict()
    after, _, _ = load_torch_checkpoint(last)
    moved = [k for k in before if k.endswith('weight')
             and not torch.equal(before[k], after[k])]
    assert all(torch.isfinite(v.float()).all() for v in after.values())
    assert len(moved) > 0.9 * sum(k.endswith('weight') for k in before)
    log(f'train: {len(moved)} weight tensors moved from the initial '
        f'weights; weights/last/model.pt written')

    model, meta = load_model(last, device=DEVICE)
    rng = np.random.default_rng(11)
    u8 = torch.from_numpy(np.array(_image(rng, IMG, IMG)[None, None])).to(
        DEVICE)
    prob = make_predict_step_u8(model)(u8)
    sync()
    assert prob.shape == (1, 2, IMG, IMG) and torch.isfinite(prob).all()
    log(f'train: weights/last/model.pt (epoch {meta["epoch"]}) loaded '
        f'by cli/predict.load_model and segmented a {IMG}^2 slice: '
        f'{int((prob[0, 1] > 0.5).sum())} tumor px')
    out['aug_on'] = hist

    # the same run with augmentation off (not the main path)
    cfg = load_config(config)
    off = dict(cfg, augmentation=dict(cfg['augmentation'],
                                      enabled=False))
    off_path = f'{tmp}/aug_off.yaml'
    with open(off_path, 'w') as f:
        yaml.safe_dump(off, f)
    out['aug_off'] = run_train_cli(tmp, 'aug_off', off_path, init_pt)
    n_train = 16 * 4
    for k, hist in out.items():
        secs = hist['train_seconds']
        log(f'TIME train {k}: ' + ', '.join(
            f'epoch {i + 1} {n_train / t:.2f} slices/s ({t:.3f} s)'
            for i, t in enumerate(secs)) + f'  [{card}]')
    return launches, out['aug_on']['save_dir']


def resume_path(card, tmp, run_dir):
    """``--resume`` of the augmentation-on run to a third epoch with
    ``--profile-dir``: the epoch counter continues at 3, the warp runs
    once per super-batch of that one epoch, the trace names the warp
    kernel, and the plots are drawn (or skipped with one line where
    matplotlib is missing)."""
    from unet_tpu_torch.cli import train as train_cli
    from unet_tpu_torch.ops import warp
    from unet_tpu_torch.utils.plots import SKIP_MESSAGE, have_matplotlib
    prof = f'{tmp}/profile'
    argv = ['--config', one_rank_config(tmp), '--project', tmp, '--name',
            'aug_on_resumed', '--resume', f'{run_dir}/weights/last',
            '--profile-dir', prof, *TRAIN_ARGS[:-2], '--epochs', '3']
    if DEVICE == 'cpu':
        argv += ['--device', 'cpu']
    warp.launch_count = 0
    t0 = time.perf_counter()
    hist = train_cli.main(argv)
    wall = time.perf_counter() - t0
    launches = warp.launch_count
    meta = json.loads(open(f'{hist["save_dir"]}/weights/last/meta.json')
                      .read())
    traces = glob.glob(f'{prof}/trace_*.json')
    # the CUDA kernel's name; a CPU rehearsal has only the ATen ops
    needle = 'warp_kernel' if DEVICE == 'cuda' else 'aten::'
    names_warp = bool(traces) and needle in open(traces[0]).read()
    plots = have_matplotlib()
    log(f'resume: --resume {run_dir}/weights/last --epochs 3 ran epoch '
        f'{meta["epoch"] + 1} (optimizer step {meta["step"]}) in {wall:.1f} '
        f's with {launches} warp kernel launches; train loss '
        f'{hist["train_loss"]}; profiler trace {traces[0] if traces else None}'
        f' ({os.path.getsize(traces[0]) / 1e6 if traces else 0:.1f} MB) '
        f'names the warp kernel: {names_warp}; plots: '
        + ('training_curves.png and val_predictions.png written' if plots
           else SKIP_MESSAGE))
    assert len(hist['train_loss']) == 1 and meta['epoch'] == 2, meta
    assert launches == TRAIN_SUPERBATCHES // 2, launches
    assert names_warp
    assert all(np.isfinite(hist['train_loss'] + hist['val_loss']))
    if plots:
        for png in ('training_curves.png', 'val_predictions.png'):
            assert os.path.getsize(f'{hist["save_dir"]}/{png}') > 0, png
    return launches


def export_path(card, run_dir):
    """``cli/export_torch.py`` on the train phase's ``weights/best``:
    ``load_model`` reads the directory and the exported .pt, and their
    logits on a 512^2 batch are equal."""
    import torch
    from unet_tpu_torch.cli import export_torch
    from unet_tpu_torch.cli.predict import load_model
    best = f'{run_dir}/weights/best'
    out = f'{run_dir}/exported/best.pt'
    argv = ['--weights', best, '--output', out]
    if DEVICE == 'cpu':
        argv += ['--device', 'cpu']
    meta = export_torch.main(argv)
    from_dir, dmeta = load_model(best, device=DEVICE)
    from_pt, pmeta = load_model(out, device=DEVICE)
    rng = np.random.default_rng(23)
    u8 = np.stack([_image(rng, IMG, IMG) for _ in range(2)])[:, None]
    x = (torch.from_numpy(u8).to(DEVICE).float() / 255.0 - 0.5) / 0.5
    with torch.inference_mode():
        a, b = from_dir(x), from_pt(x)
    payload = torch.load(out, map_location='cpu', weights_only=False)
    log(f'export: {best} -> {out} ({os.path.getsize(out) / 1e6:.1f} MB, '
        f'epoch {payload["epoch"]}, keys {sorted(payload)}); load_model '
        f'read both (epoch {dmeta["epoch"]} / {pmeta["epoch"]}): logits '
        f'equal {torch.equal(a, b)} on a {IMG}^2 batch of 2  [{card}]')
    assert torch.equal(a, b) and torch.isfinite(a).all()
    assert payload['epoch'] == meta['epoch'] == dmeta['epoch']
    assert set(payload) == {'epoch', 'model_state_dict',
                            'optimizer_state_dict', 'metrics', 'config'}


def overfit_path(card, tmp):
    """``unet_tpu_torch.cli.overfit --synthetic --model attention_unet``
    at its defaults (256^2, base 64, 4 samples) but OVERFIT_EPOCHS
    epochs: must PASS."""
    from unet_tpu_torch.cli import overfit
    argv = ['--synthetic', '--model', 'attention_unet', '--output',
            f'{tmp}/overfit', '--epochs', str(OVERFIT_EPOCHS)]
    if DEVICE == 'cpu':
        argv += ['--device', 'cpu', '--img-size', str(IMG),
                 '--base-features', str(BASE), '--samples', '2',
                 '--epochs', '60']
    args = overfit.parse_args(argv)
    t0 = time.perf_counter()
    res = overfit.run_overfit(args)
    wall = time.perf_counter() - t0
    log(f'overfit: {args.model} base {args.base_features} '
        f'{args.img_size}^2, {len(res["picked"])} samples, {args.epochs} '
        f'epochs: final tumor Dice {res["final_dice"]:.4f} '
        f'({"PASS" if res["passed"] else "FAIL"}) in {wall:.1f} s; '
        f'{args.epochs / wall:.2f} steps/s (train + eval, host clock)  '
        f'[{card}]')
    assert res['passed'], res['final_dice']
    return res


# ---------------------------------------------------------------- cache

def write_pngs(root, volumes, slices):
    """The synthetic dataset at IMG^2 as ``root/{images,labels}/*.png``,
    through PIL; returns the number of slices."""
    from PIL import Image
    from unet_tpu_torch.data.dataset import SyntheticSliceDataset
    ds = SyntheticSliceDataset(num_volumes=volumes, slices_per_volume=slices,
                               img_size=IMG, split='all')
    for d in ('images', 'labels'):
        os.makedirs(f'{root}/{d}', exist_ok=True)
    for i, name in enumerate(ds.files):
        img, msk = ds.load_raw(i)
        Image.fromarray(img).save(f'{root}/images/{name}')
        Image.fromarray(msk * 255).save(f'{root}/labels/{name}')
    return len(ds)


def cache_path(card, tmp):
    """The slice cache: synthetic PNGs written through PIL, the blob built
    by ``build_cache`` and held byte for byte against the PNG loader, the
    loader alone timed on both, then the train CLI on the flagship config
    with ``--cache`` (a main path: warp launches counted around it).
    Returns (cache path, the --cache run's history)."""
    from unet_tpu_torch.cli import train as train_cli
    from unet_tpu_torch.data.cache import CachedSliceDataset, build_cache
    from unet_tpu_torch.data.dataset import BatchLoader, SliceDataset
    from unet_tpu_torch.ops import warp
    root, blob = f'{tmp}/pngs', f'{tmp}/slices.bin'
    t0 = time.perf_counter()
    n = write_pngs(root, *CACHE_DATA)
    t_png = time.perf_counter() - t0
    t0 = time.perf_counter()
    build_cache(root, blob, img_size=IMG)
    t_build = time.perf_counter() - t0
    native = json.loads(open(blob + '.json').read())['native']
    cached = CachedSliceDataset(blob, split='all')
    png = SliceDataset(root, split='all', img_size=IMG)
    assert cached.files == png.files and len(cached) == n
    for i in range(n):
        for a, b in zip(cached.load_raw(i), png.load_raw(i)):
            assert a.shape == b.shape == (IMG, IMG) and np.array_equal(a, b), (
                png.files[i])
    log(f'cache: {n} PNGs of {IMG}^2 written in {t_png:.1f} s; build_cache '
        f'ran the {"native (libpng)" if native else "PIL"} builder in '
        f'{t_build:.2f} s ({os.path.getsize(blob) / 1e6:.1f} MB); '
        f'CachedSliceDataset.load_raw equals SliceDataset.load_raw on all '
        f'{n} slices, byte for byte')
    # the loader alone, as the train CLI builds it: what each source
    # costs the host per epoch, apart from the card
    rates = {}
    for name, ds in (('cache', cached), ('PNGs', png)):
        loader = BatchLoader(ds, 4, shuffle=True, drop_last=True,
                             raw_uint8=True)
        for _ in range(2):  # the second pass reads a warm page cache
            t0 = time.perf_counter()
            rows = sum(len(b[0]) for b in loader)
            rates[name] = rows / (time.perf_counter() - t0)
    log(f'TIME loader alone, batch 4, 8 threads, second pass over {n} '
        f'slices: cache {rates["cache"]:.0f} slices/s, PNGs (PIL decode) '
        f'{rates["PNGs"]:.0f} slices/s  [{card}]')

    argv = ['--config', one_rank_config(tmp), '--project', tmp,
            '--init-weights', f'{tmp}/init.pt', '--data', root, '--epochs',
            '2', '--name', 'cached', '--cache', blob]
    if DEVICE == 'cpu':
        argv += ['--device', 'cpu']
    warp.launch_count = 0
    hist = train_cli.main(argv)
    launches = warp.launch_count
    assert launches == TRAIN_SUPERBATCHES, launches
    assert all(np.isfinite(hist['train_loss'] + hist['val_loss']))
    n_train = len(CachedSliceDataset(blob, split='train'))
    log(f'TIME train --cache: ' + ', '.join(
        f'epoch {i + 1} {n_train / t:.2f} slices/s ({t:.3f} s)'
        for i, t in enumerate(hist['train_seconds'])) + f'  [{card}]')
    log(f'cache: train CLI --cache on {TRAIN_CONFIG}: {launches} warp '
        f'launches for {TRAIN_SUPERBATCHES} super-batches; train loss '
        f'{hist["train_loss"]}, val loss {hist["val_loss"]}')
    return blob, hist


# ---------------------------------------------------------------- 2 ranks

def parity_batch(blob, path):
    """The one-step parity's fixed global batch: the first DIST_BATCH
    training slices of the cache, saved for the ranks."""
    from unet_tpu_torch.data.cache import CachedSliceDataset
    ds = CachedSliceDataset(blob, split='train')
    pairs = [ds.load_raw(i) for i in range(DIST_BATCH)]
    np.savez(path, imgs=np.stack([p[0] for p in pairs])[:, None],
             msks=np.stack([p[1] for p in pairs]))


def one_step(init_pt, batch_path, rank, world):
    """Loss and gradient norm of ``TrainStep.accumulate`` (one microbatch,
    this rank's rows of the fixed batch, the step's one reduction over
    the ranks) for the flagship model from ``init_pt``, in float32 and
    bfloat16: {dtype: (loss, grad norm)}."""
    import torch
    from unet_tpu_torch.models import create_model
    from unet_tpu_torch.train.trainer import create_optimizer, make_train_step
    from unet_tpu_torch.utils.torch_port import load_torch_checkpoint
    cfg = _train_cfg()
    state, _, _ = load_torch_checkpoint(init_pt)
    data = np.load(batch_path)
    lb = DIST_BATCH // world
    rows = slice(rank * lb, (rank + 1) * lb)
    imgs = torch.from_numpy(data['imgs'][rows]).to(DEVICE).float()[None]
    imgs = (imgs / 255.0 - 0.5) / 0.5
    msks = torch.from_numpy(data['msks'][rows]).to(DEVICE)[None]
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        m = cfg['model']
        model = create_model(m['type'], base_features=m['base_features'],
                             dtype=dtype)
        model.load_state_dict(state, strict=True)
        model = model.to(DEVICE, memory_format=torch.channels_last)
        step = make_train_step(model, _loss_fn(cfg),
                               create_optimizer(model, 1e-4), accum_steps=1)
        loss = step.accumulate(imgs, msks, [1.0])
        gnorm = torch.sqrt(sum(torch.sum(p.grad.double() ** 2)
                               for p in model.parameters()))
        out[str(dtype).split('.')[-1]] = (float(loss), float(gnorm))
        del model, step
    return out


def time_rank_step(world):
    """One rank's optimizer step on the flagship super-batch (its
    SUPER / world rows), the step's flat gradient all-reduce alone, and
    one BatchNorm statistics all-reduce, host clock around synchronized
    calls (the collectives block the host under gloo)."""
    import torch
    import torch.distributed as dist
    from unet_tpu_torch.core.distributed import all_reduce_sum
    from unet_tpu_torch.models import create_model
    from unet_tpu_torch.models.layers import TorchBatchNorm
    from unet_tpu_torch.train.trainer import (average_over_ranks,
                                              create_optimizer,
                                              make_train_step)
    cfg = _train_cfg()
    m, tc = cfg['model'], cfg['train']
    a = tc['accumulation_steps']
    lb = cfg['data']['batch_size'] // world
    model = create_model(m['type'], base_features=m['base_features'],
                         dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(3))
    model = model.to(DEVICE, memory_format=torch.channels_last)
    step = make_train_step(model, _loss_fn(cfg),
                           create_optimizer(model, 1e-6), a,
                           grad_clip=tc['grad_clip'])
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    imgs = torch.randn(a, lb, 1, IMG, IMG, generator=gen, device=DEVICE)
    msks = (torch.rand(a, lb, IMG, IMG, generator=gen, device=DEVICE)
            > 0.9).to(torch.uint8)
    mb = np.ones(a, np.float32)

    def host_ms(fn, reps):
        fn()
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        return (time.perf_counter() - t0) / reps * 1e3

    torch.cuda.reset_peak_memory_stats()
    t_step = host_ms(lambda: step(imgs, msks, 1e-6, mb), 1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    grads = [p.grad for p in model.parameters()]
    loss = torch.zeros((), device=DEVICE)
    t_grad = host_ms(lambda: average_over_ranks(grads, loss), 3)
    bns = [mod for mod in model.modules() if isinstance(mod, TorchBatchNorm)]
    widest = max(bn.weight.numel() for bn in bns)
    stats = torch.zeros(2 * widest + 1, device=DEVICE)
    t_bn = host_ms(lambda: all_reduce_sum(stats), 20)
    n_grad = sum(g.numel() for g in grads)
    return {'step_ms': t_step, 'grad_allreduce_ms': t_grad,
            'grad_mb': (n_grad + 1) * 4 / 1e6, 'bn_allreduce_ms': t_bn,
            # forward and backward of each BatchNorm, per microbatch
            'bn_allreduces': 2 * len(bns) * a, 'step_peak_gib': peak}


def dist_worker(argv):
    """One rank of the distributed phase, run as ``chip_smoke.py
    --dist-worker DEVICE CONFIG COORDINATOR RANK WORLD TMP``: joins the group,
    runs the one-step parity and the step timings, then the train CLI as
    that rank (warp launches counted around it), and prints its results
    as one ``DIST {json}`` line."""
    global DEVICE, TRAIN_CONFIG
    import torch
    from unet_tpu_torch.cli import train as train_cli
    from unet_tpu_torch.core.distributed import init_distributed
    from unet_tpu_torch.ops import warp
    DEVICE, TRAIN_CONFIG, coordinator, rank, world, tmp = argv
    rank, world = int(rank), int(world)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if DEVICE == 'cuda':
        torch.cuda.set_device(0)
    init_distributed(coordinator, world, rank, DEVICE, timeout_seconds=600)
    out = {'rank': rank,
           'parity': one_step(f'{tmp}/init.pt', f'{tmp}/parity.npz', rank,
                              world)}
    if DEVICE == 'cuda':
        out.update(time_rank_step(world))
        torch.cuda.reset_peak_memory_stats()
    argv = ['--config', TRAIN_CONFIG, '--project', f'{tmp}/dist', '--name',
            'run', '--init-weights', f'{tmp}/init.pt', '--cache',
            f'{tmp}/slices.bin', '--epochs', '2', '--coordinator',
            coordinator, '--num-processes', str(world), '--process-id',
            str(rank)]
    if DEVICE == 'cpu':
        argv += ['--device', 'cpu']
    warp.launch_count = 0
    hist = train_cli.main(argv)
    out['warp_launches'] = warp.launch_count
    out['cli_warp_launches'] = hist['warp_launches']
    out['train_seconds'] = hist['train_seconds']
    out['train_loss'], out['val_loss'] = hist['train_loss'], hist['val_loss']
    out['save_dir'] = hist['save_dir']
    if DEVICE == 'cuda':
        out['cli_peak_gib'] = torch.cuda.max_memory_allocated() / 2 ** 30
    print('DIST ' + json.dumps(out), flush=True)
    return 0


def run_ranks(tmp, world, env):
    """Start ``world`` rank processes of this script and wait for all,
    killing every one still running after DIST_TIMEOUT s; returns each
    rank's DIST result."""
    from unet_tpu_torch.core.mesh import free_port
    coordinator = f'127.0.0.1:{free_port()}'
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), '--dist-worker', DEVICE,
         one_rank_config(tmp), coordinator, str(r), str(world), tmp],
        env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DIST_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    with open(f'{tmp}/dist_ranks.log', 'w') as f:
        f.write('\n'.join(outs))
    results = []
    for p, out in zip(procs, outs):
        lines = [l for l in out.splitlines() if l.startswith('DIST ')]
        if p.returncode != 0 or not lines:
            raise RuntimeError(f'rank exited with {p.returncode}:\n'
                               + out[-6000:])
        results.append(json.loads(lines[-1][5:]))
    return results


def distributed_path(card, tmp, blob, single):
    """Two ranks on the one card over gloo: the one-step parity against
    this process, the train CLI's 2-epoch run against the single-process
    ``--cache`` run (``single``, same init, same cache), one run
    directory, warp launches on each rank, step and collective times."""
    import torch
    from unet_tpu_torch.core.distributed import BACKEND_ENV
    parity_batch(blob, f'{tmp}/parity.npz')
    want = one_step(f'{tmp}/init.pt', f'{tmp}/parity.npz', 0, 1)
    log(f'dist: NCCL refuses two ranks on one device, so the two ranks '
        f'share the card over gloo ({BACKEND_ENV}=gloo); one card, so no '
        f'number below is a scaling figure')
    env = dict(os.environ, **{BACKEND_ENV: 'gloo'})
    t0 = time.perf_counter()
    ranks = run_ranks(tmp, 2, env)
    wall = time.perf_counter() - t0
    held = []  # every reading is printed before the first assert
    for dtype, (loss, gnorm) in want.items():
        tol = DIST_TOL[dtype]
        for r in ranks:
            got_loss, got_norm = r['parity'][dtype]
            rel_loss = abs(got_loss / loss - 1)
            rel_norm = abs(got_norm / gnorm - 1)
            log(f'dist: one-step parity {dtype} rank {r["rank"]}: loss '
                f'{got_loss:.7f} vs one process {loss:.7f} (rel '
                f'{rel_loss:.2e}), grad norm {got_norm:.6f} vs {gnorm:.6f} '
                f'(rel {rel_norm:.2e}); tolerance rel {tol["loss"]} / '
                f'{tol["gnorm"]}')
            held.append((rel_loss <= tol['loss'] and rel_norm <= tol['gnorm'],
                         dtype, r['rank']))
    runs = sorted(os.listdir(f'{tmp}/dist'))
    for r in ranks:
        log(f'dist: rank {r["rank"]}: {r["warp_launches"]} warp kernel '
            f'launches (its rows of {TRAIN_SUPERBATCHES} super-batches); '
            f'train loss {r["train_loss"]}, val loss {r["val_loss"]}')
    drift = weight_drift(tmp, single, f'{tmp}/dist/run')
    d_train = abs(ranks[0]['train_loss'][-1] - single['train_loss'][-1])
    d_val = abs(ranks[0]['val_loss'][-1] - single['val_loss'][-1])
    log(f'dist: 2 epochs on 2 ranks against one process (same init, '
        f'cache and draws): |w2 - w1| / |w1 - w0| = {drift:.4f} (bound '
        f'{DIST_DRIFT}), epoch-2 train loss {d_train:.5f} and val loss '
        f'{d_val:.5f} apart (bound {DIST_LOSS}); only rank 0 wrote a run '
        f'directory: {runs}')
    assert all(ok for ok, *_ in held), [h for h in held if not h[0]]
    assert runs == ['run'], runs
    assert all(r['save_dir'] == f'{tmp}/dist/run' for r in ranks)
    for r in ranks:
        # a CPU rehearsal takes the warp's plain version, never the kernel
        assert r['warp_launches'] == TRAIN_SUPERBATCHES or DEVICE == 'cpu', r
        # the CLI's own report of every rank's launches agrees
        assert r['cli_warp_launches'] == [x['warp_launches'] for x in ranks]
        assert r['train_loss'] == ranks[0]['train_loss']
        assert all(np.isfinite(r['train_loss'] + r['val_loss']))
    assert drift <= DIST_DRIFT and d_train <= DIST_LOSS and d_val <= DIST_LOSS
    if DEVICE == 'cuda':
        for r in ranks:
            log(f'TIME 2-rank step rank {r["rank"]} (gloo, both ranks on '
                f'one card; {SUPER // 2} of the {SUPER} slices of a '
                f'super-batch): optimizer step {r["step_ms"]:.2f} ms, of '
                f'which the flat gradient all-reduce ({r["grad_mb"]:.1f} MB) '
                f'{r["grad_allreduce_ms"]:.2f} ms alone and '
                f'{r["bn_allreduces"]} BatchNorm all-reduces of '
                f'{r["bn_allreduce_ms"]:.3f} ms each alone '
                f'({r["bn_allreduces"] * r["bn_allreduce_ms"]:.1f} ms); CLI '
                f'epochs ' + ', '.join(f'{t:.3f} s' for t in
                                       r['train_seconds'])
                + f'; peak device memory {r["step_peak_gib"]:.2f} GiB in the '
                f'step, {r["cli_peak_gib"]:.2f} GiB in the CLI run  [{card}]')
    log(f'dist: 2 rank processes ran in {wall:.1f} s')
    if DEVICE == 'cuda' and torch.cuda.device_count() > 1:
        nccl_path(card, tmp, blob, single, torch.cuda.device_count())
    else:
        log('dist: one GPU, so the NCCL route (one rank per GPU) was not run')
    return ranks


def weight_drift(tmp, single, run_dir):
    """|w - w1| / |w1 - w0| over the weights and biases: the distance of
    ``run_dir``'s last weights from the single-process run's, in units
    of how far that run moved from the init."""
    import torch
    from unet_tpu_torch.utils.torch_port import load_torch_checkpoint
    init, _, _ = load_torch_checkpoint(f'{tmp}/init.pt')
    one, _, _ = load_torch_checkpoint(
        f'{single["save_dir"]}/weights/last/model.pt')
    other, _, _ = load_torch_checkpoint(f'{run_dir}/weights/last/model.pt')
    keys = [k for k in init if k.endswith(('weight', 'bias'))]

    def norm(a, b):
        return float(torch.sqrt(sum(torch.sum((a[k] - b[k]).double() ** 2)
                                    for k in keys)))

    return norm(other, one) / norm(one, init)


def nccl_path(card, tmp, blob, single, gpus):
    """One rank per GPU, spawned by one train CLI command through
    ``tpu.data_parallel`` (the largest count of ``gpus`` that divides the
    global batch): each rank's warp launches from the CLI's own report,
    the weights held loosely against the single-process run. NCCL on the
    card; a CPU rehearsal takes gloo."""
    import yaml
    cfg = _train_cfg()
    batch = cfg['data']['batch_size']
    n = max(d for d in range(1, gpus + 1) if batch % d == 0)
    cfg['tpu']['data_parallel'] = n
    path = f'{tmp}/nccl.yaml'
    with open(path, 'w') as f:
        yaml.safe_dump(cfg, f)
    env = {k: v for k, v in os.environ.items()
           if k != 'UNET_TORCH_DIST_BACKEND'}
    argv = ['--config', path, '--project', f'{tmp}/nccl', '--name', 'run',
            '--init-weights', f'{tmp}/init.pt', '--cache', blob, '--epochs',
            '2']
    if DEVICE == 'cpu':
        argv += ['--device', 'cpu']
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, '-m', 'unet_tpu_torch.cli.train', *argv], env=env,
        capture_output=True, text=True, timeout=DIST_TIMEOUT)
    wall = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    lines = [l.strip() for l in proc.stdout.splitlines()]
    backend = 'nccl' if DEVICE == 'cuda' else 'gloo'
    line = [l for l in lines if l.startswith('Data parallel')]
    assert line == [f'Data parallel: {n} ranks, {backend} backend'], line
    prefix = 'Warp kernel launches per rank: '
    launches = json.loads([l for l in lines
                           if l.startswith(prefix)][-1][len(prefix):])
    hist = json.loads(open(f'{tmp}/nccl/run/history.json').read())
    drift = weight_drift(tmp, single, f'{tmp}/nccl/run')
    d_val = abs(hist['val_loss'][-1] - single['val_loss'][-1])
    epochs = [l for l in lines if 'Train Loss' in l]
    log(f'dist: {backend} route ran: {line[0]}, one rank per device, from '
        f'one command in {wall:.1f} s; warp kernel launches per rank '
        f'{launches}; |w - w1| / |w1 - w0| = {drift:.4f} (bound '
        f'{DIST_DRIFT}), epoch-2 val loss {d_val:.5f} apart; epochs: '
        f'{epochs}  [{card}]')
    assert len(launches) == n
    # a CPU rehearsal takes the warp's plain version, never the kernel
    assert (all(k == TRAIN_SUPERBATCHES for k in launches)
            or DEVICE == 'cpu'), launches
    assert drift <= DIST_DRIFT and d_val <= DIST_LOSS


def _train_cfg():
    from unet_tpu_torch.utils.config import load_config
    return load_config(TRAIN_CONFIG)


def _loss_fn(cfg):
    from unet_tpu_torch.train.losses import create_loss_function
    lc = cfg['loss']
    return create_loss_function(
        lc['type'], ce_weight=lc['ce_weight'], dice_weight=lc['dice_weight'],
        balanced_class_weight=lc['balanced_class_weight'])


# ---------------------------------------------------------------- times

def time_gates(card, errs):
    import torch
    from unet_tpu_torch.ops import attention_gate as ag
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=DEVICE)
    total = {'ms': 0.0, 'plain_ms': 0.0, 'bound_ms': 0.0, 't_bytes': 0.0,
             't_ops': 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split('.')[-1]
        for i, (cg, h, cx, inter) in enumerate(GATES):
            args = gate_inputs(cg, h, cx, inter, dtype, seed=i)
            bound, by, nbytes, flops = gate_bound(cg, h, cx, inter, dtype)
            with torch.no_grad():
                k1 = time_ms(lambda: ag.attention_gate_fused(*args), 10, flush)
                p1 = time_ms(lambda: ag.attention_gate_reference(*args), 5,
                             flush)
                k2 = time_ms(lambda: ag.attention_gate_fused(*args), 10, flush)
            ms = (k1 + k2) / 2
            log(f'TIME gate {i + 1} {name} b{BATCH} g={cg}x{h}^2 '
                f'x={cx}x{2 * h}^2 I={inter}: kernel {k1:.4f} / {k2:.4f} ms, '
                f'plain {p1:.4f} ms, bound {bound:.4f} ms ({by}; '
                f'{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), '
                f'roofline share {bound / ms:.1%}  [{card}]')
            if dtype == torch.bfloat16:  # the main path's type
                total['ms'] += ms
                total['plain_ms'] += p1
                total['bound_ms'] += bound
                total['t_bytes'] += nbytes / HBM_BYTES_PER_S * 1e3
                total['t_ops'] += flops / PEAK_FLOPS[name] * 1e3
    del flush
    total['bound_by'] = ('bytes' if total['t_bytes'] >= total['t_ops']
                         else 'operations')
    log(f'TIME gates, the four of one bf16 forward at b{BATCH}: kernel '
        f'{total["ms"]:.4f} ms, plain {total["plain_ms"]:.4f} ms, bound '
        f'{total["bound_ms"]:.4f} ms ({total["bound_by"]}), roofline share '
        f'{total["bound_ms"] / total["ms"]:.1%}; the earlier design took '
        f'{PREV_MS["attention_gate"]} ms  [{card}]')
    total['max_abs_err'] = max(e for (i, n), e in errs.items()
                               if n == 'bfloat16')
    return total


def time_launch_host(card):
    """Host cost of one launch of the two tensor-core kernels, tiny inputs
    so the card keeps up, host clock over back-to-back calls with the
    synchronize after the clock is read: the whole wrapper call (checks,
    output allocation, ctypes), and the C launch function alone (the TMA
    tensor maps it encodes on every launch, the attribute call, the
    launch), called through ctypes on the same pointers."""
    import torch
    from unet_tpu_torch.ops import attention_gate as ag
    from unet_tpu_torch.ops import conv3x3 as cv
    cl = torch.channels_last
    x = torch.randn(1, 64, 8, 16, device=DEVICE).to(
        torch.bfloat16).contiguous(memory_format=cl)
    k = torch.randn(3, 3, 64, 64, device=DEVICE).to(torch.bfloat16)
    y = torch.empty_like(x)
    gate = gate_inputs(64, 16, 64, 32, torch.bfloat16, seed=0, n=1)
    g, gx, wg, wx, badd, wpsi, bpsi = gate
    gy = torch.empty_like(gx)
    stream = torch.cuda.current_stream().cuda_stream
    conv_c, gate_c = cv._lib().conv3x3_launch, ag._lib().attention_gate_launch
    calls = {
        'conv3x3 wrapper': lambda: cv.conv3x3(x, k),
        'conv3x3 C launch (3 maps)': lambda: conv_c(
            1, x.data_ptr(), k.data_ptr(), None, None, y.data_ptr(), 1, 8,
            16, 64, 64, 0, stream),
        'attention_gate wrapper': lambda: ag.attention_gate_fused(*gate),
        'attention_gate C launch (4 maps)': lambda: gate_c(
            1, g.data_ptr(), gx.data_ptr(), wg.data_ptr(), wx.data_ptr(),
            badd.data_ptr(), wpsi.data_ptr(), bpsi.data_ptr(), gy.data_ptr(),
            1, 16, 16, 32, 32, 64, 64, 32, 0, 0, 16, 32,
            ag._align_scale(16, 32), ag._align_scale(16, 32), stream)}
    reps = 500
    out = {}
    with torch.no_grad():
        for name, fn in calls.items():
            for _ in range(20):
                r = fn()
                assert torch.is_tensor(r) or r == 0, (name, r)
            sync()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            out[name] = (time.perf_counter() - t0) / reps * 1e6
            sync()
    log(f'TIME host cost of one launch, tensor maps encoded every time '
        f'(host clock, {reps} back-to-back calls on tiny inputs): '
        + ', '.join(f'{name} {us:.1f} us' for name, us in out.items())
        + f'  [{card}]')


def time_warp(card, err):
    import torch
    from unet_tpu_torch.ops import warp
    img, msk, cases = warp_cases()
    rows, cols = cases['augment']
    bound, by, nbytes = warp_bound(SUPER, IMG, IMG)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=DEVICE)
    args = (img, msk, rows, cols)
    k1 = time_ms(lambda: warp.grid_sample_fused(*args), 20, flush)
    p1 = time_ms(lambda: warp.grid_sample_fused_reference(*args), 5, flush)
    k2 = time_ms(lambda: warp.grid_sample_fused(*args), 20, flush)
    ms = (k1 + k2) / 2
    log(f'TIME warp {SUPER}x{IMG}^2 (augmentation coords): kernel '
        f'{k1:.4f} / {k2:.4f} ms, plain {p1:.4f} ms, bound {bound:.4f} ms '
        f'({by}; {nbytes / 1e6:.1f} MB), roofline share {bound / ms:.1%}  '
        f'[{card}]')
    return {'ms': ms, 'plain_ms': p1, 'bound_ms': bound, 'bound_by': by,
            'max_abs_err': err}


def time_train_parts(card):
    """The augmentation program per super-batch, and one optimizer step
    (8 microbatches of 4 forward and backward, clip, AdamW) in bf16."""
    import torch
    from unet_tpu_torch.data.augmentations import (AugmentConfig,
                                                   augment_batch_seeded,
                                                   draw_augment_params,
                                                   generator_for_step,
                                                   local_rows)
    from unet_tpu_torch.models import create_model
    from unet_tpu_torch.train.trainer import (clip_by_global_norm,
                                              create_optimizer,
                                              make_train_step)
    from unet_tpu_torch.utils.config import load_config
    cfg = load_config(TRAIN_CONFIG)
    img, msk, _ = warp_cases(seed=1)
    aug = AugmentConfig.from_yaml(cfg['augmentation'])
    t_aug = time_ms(lambda: augment_batch_seeded(img, msk, 43, 0, aug), 10)
    # a rank of two draws the whole super-batch's parameters and applies
    # its half: the draws alone, global and half, and the rank's call
    a = cfg['train']['accumulation_steps']
    dev = torch.device(DEVICE)

    def draws(n):
        return draw_augment_params(n, IMG, IMG, aug,
                                   generator_for_step(43, 0, dev), dev)

    t_draw = time_ms(lambda: draws(SUPER), 10)
    t_draw_half = time_ms(lambda: draws(SUPER // 2), 10)
    rows = local_rows(a, SUPER // a // 2, 0, 2, dev)
    img_r, msk_r = img[rows].contiguous(), msk[rows].contiguous()
    t_aug_rank = time_ms(lambda: augment_batch_seeded(
        img_r, msk_r, 43, 0, aug, local_slice=(0, 2), groups=a), 10)
    draw_mb = sum(t.numel() * t.element_size() for t in
                  vars(draws(SUPER)).values()) / 1e6

    m = cfg['model']
    model = create_model(m['type'], base_features=m['base_features'],
                         dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(3))
    model = model.to(DEVICE, memory_format=torch.channels_last)
    tc = cfg['train']
    opt = create_optimizer(model, tc['lr'], tc['weight_decay'])
    loss_fn = _loss_fn(cfg)
    step = make_train_step(model, loss_fn, opt,
                           tc['accumulation_steps'],
                           grad_clip=tc['grad_clip'])
    a = tc['accumulation_steps']
    imgs = (img.reshape(a, SUPER // a, 1, IMG, IMG) - 0.5) / 0.5
    msks = msk.reshape(a, SUPER // a, IMG, IMG)
    mb = np.ones(a, np.float32)
    torch.cuda.reset_peak_memory_stats()
    t_step = time_ms(lambda: step(imgs, msks, 1e-6, mb), 3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    def fwd_bwd():
        loss_fn(model(imgs[0]), msks[0]).backward()

    def clip_adamw():
        clip_by_global_norm([p.grad for p in model.parameters()],
                            tc['grad_clip'])
        opt.step()

    t_fb = time_ms(fwd_bwd, 5)
    t_opt = time_ms(clip_adamw, 5)
    busy, wall, top = device_busy(lambda: step(imgs, msks, 1e-6, mb))
    log(f'TIME augmentation program {SUPER}x{IMG}^2 per super-batch '
        f'(draws, elastic smoothing, warp, photometric): {t_aug:.3f} ms  '
        f'[{card}]')
    log(f'TIME augmentation draws: the whole {SUPER}-slice super-batch\'s '
        f'parameters ({draw_mb:.1f} MB) {t_draw:.3f} ms, {SUPER // 2} '
        f'slices\' {t_draw_half:.3f} ms; one rank of two (global draws, '
        f'its {SUPER // 2} rows augmented) {t_aug_rank:.3f} ms  [{card}]')
    log(f'TIME optimizer step (8 x b4 {IMG}^2 bf16 forward+backward, clip, '
        f'AdamW): {t_step:.2f} ms = {SUPER / t_step * 1e3:.2f} slices/s; '
        f'one microbatch forward+backward {t_fb:.2f} ms, clip+AdamW '
        f'{t_opt:.2f} ms; peak device memory {peak:.2f} GiB  [{card}]')
    log(f'TIME optimizer step under torch.profiler: wall {wall:.2f} ms, '
        + (f'device busy {busy:.2f} ms ({busy / wall:.1%}), idle share '
           f'{1 - busy / wall:.1%}' if busy else
           'no device time in key_averages(): idle share not measured')
        + f'  [{card}]')
    for name, ms, calls in top:
        log(f'  kernel {ms:8.2f} ms {calls:5d}x  {name[:90]}')


def device_busy(fn, top=12):
    """(device ms, wall ms, top kernels) of one fn() under
    torch.profiler: the sum of the CUDA kernels' self time, the host
    clock around the call ending in a synchronize, and the ``top``
    kernels by device time as (name, ms, calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = []
    for e in prof.key_averages():
        if getattr(e, 'device_type', None) == torch.autograd.DeviceType.CUDA:
            us = getattr(e, 'self_device_time_total',
                         getattr(e, 'self_cuda_time_total', 0.0))
            kernels.append((e.key, us / 1e3, e.count))
    kernels.sort(key=lambda k: -k[1])
    return sum(k[1] for k in kernels), wall, kernels[:top]


# ------------------------------------------------------ measurement modes

AB_CHILD = """
import sys, torch
import chip_smoke as s
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
from unet_tpu_torch.ops import _build
_build.build_all()
card = s.card_line()
model, x = s.check_model(card)
del x
torch.cuda.empty_cache()
s.serve_main_path(model, card)
s.predict_path(model, card)
"""
AB_PATTERNS = {
    'serve_slices_per_s': r'TIME serve ([0-9.]+) slices/s',
    'serve_p50_ms': r'TIME serve .*? p50 ([0-9.]+) ms',
    'serve_device_ms': r'mean device step ([0-9.]+) ms',
    'predict_slices_per_s': r'([0-9.]+) slices/s after the first chunk',
}


def inference_ab(parent, pairs):
    """The serve and predict phases (``serve_main_path``, ``predict_path``)
    of two trees on this host, alternately, ``pairs`` times each in the
    order parent, this tree, this tree, parent, ...: one process a run
    from the tree's own root (each builds its own kernels), the readings
    parsed from its TIME lines; prints every run and the medians."""
    import re
    trees = {'parent': os.path.abspath(parent),
             'change': os.path.dirname(os.path.abspath(__file__))}
    order = [('parent', 'change'), ('change', 'parent')]
    runs = {k: [] for k in trees}
    for i in range(pairs):
        for name in order[i % 2]:
            env = dict(os.environ, PYTHONPATH=trees[name])
            res = subprocess.run([sys.executable, '-c', AB_CHILD],
                                 cwd=trees[name], env=env,
                                 capture_output=True, text=True, timeout=600)
            if res.returncode:
                print(res.stdout[-3000:], res.stderr[-3000:], file=sys.stderr)
                raise SystemExit(f'inference_ab: the {name} run failed')
            got = {k: float(re.search(p, res.stdout).group(1))
                   for k, p in AB_PATTERNS.items()}
            runs[name].append(got)
            log(f'AB run {i} {name}: {json.dumps(got)}')
    for name, rs in runs.items():
        log(f'AB median {name} over {len(rs)} runs: ' + json.dumps(
            {k: statistics.median(r[k] for r in rs) for k in AB_PATTERNS}))
    log(card_line())


def memory_ceiling():
    """The largest square image the unsharded bf16 eval forward of the
    smoke's AttentionUNet-64 (fused gate on) takes on one card, at batch
    1 and BATCH: the side doubles from IMG until a forward fails, then
    bisects in steps of 256; prints the peak memory of every size tried
    and each failure's error. Then the height-sharded forward over
    SPATIAL_BANDS bands of the same card at the first size that failed."""
    import torch
    from unet_tpu_torch.core.spatial import SpatialShardedModel
    from unet_tpu_torch.models import create_model
    card = card_line()
    model = create_model('attention_unet', base_features=BASE,
                         use_fused_gate=True,
                         generator=torch.Generator().manual_seed(0))
    model = model.to(DEVICE, memory_format=torch.channels_last).eval()
    model.dtype = torch.bfloat16

    def fits(side, nb, m=model, label='unsharded'):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            with torch.inference_mode():
                x = torch.zeros(nb, 1, side, side, device=DEVICE)
                m(x)
                sync()
        except (torch.cuda.OutOfMemoryError, RuntimeError) as e:
            log(f'memory: {label} b{nb} {side}^2 failed: '
                f'{str(e).splitlines()[0][:160]}')
            return False
        finally:
            x = None
        log(f'memory: {label} b{nb} {side}^2 peak '
            f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB')
        return True

    sharded = SpatialShardedModel(model, [torch.device(DEVICE)]
                                  * SPATIAL_BANDS)

    for nb in (1, BATCH):
        lo, hi = IMG, None
        while hi is None:
            if fits(2 * lo, nb):
                lo *= 2
            else:
                hi = 2 * lo
        while hi - lo > 256:
            mid = (lo + hi) // 2 // 256 * 256
            lo, hi = (mid, hi) if fits(mid, nb) else (lo, mid)
        log(f'memory ceiling: b{nb} fits {lo}^2, fails at {hi}^2 on one card '
            f'({torch.cuda.get_device_properties(0).total_memory / 2 ** 30:.1f}'
            f' GiB)  [{card}]')
        fits(hi, nb, sharded, f'sharded over {SPATIAL_BANDS} bands')


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this run '
              'needs an NVIDIA GPU', file=sys.stderr)
        return 2
    from unet_tpu_torch.ops import _build

    t_start = time.perf_counter()
    card = card_line()
    log(f'card: {card}')
    log(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
        f'{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} '
        f'device(s)')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    built = _build.build_all()
    PHASE_SECONDS['build'] = round(time.perf_counter() - t0, 1)
    log(f'built {", ".join(built)} in {PHASE_SECONDS["build"]} s')
    for name in built:
        for line in (_build.BUILD / f'{name}.log').read_text().splitlines():
            if 'registers' in line or 'spill' in line:
                log(f'  ptxas {name}: {line.strip()}')

    errs = timed('check_gates', check_gates)
    timed('check_gate_bands', check_gate_bands)
    warp_err = timed('check_warp', check_warp)
    timed('check_conv_edges', check_conv_edges)
    model, x = timed('check_model', check_model, card)
    tc = timed('check_convs', check_convs, model, x, card)
    del x
    torch.cuda.empty_cache()
    launches = timed('serve', serve_main_path, model, card)
    timed('predict', predict_path, model, card)
    timed('replicas', replicas_path, model, card)
    torch.cuda.empty_cache()
    timed('spatial', spatial_path, model, card)
    del model
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        warp_launches, run_dir = timed('train', train_main_path, card, tmp)
        torch.cuda.empty_cache()
        timed('resume', resume_path, card, tmp, run_dir)
        timed('export', export_path, card, run_dir)
        torch.cuda.empty_cache()
        timed('overfit', overfit_path, card, tmp)
        torch.cuda.empty_cache()
        blob, cached = timed('cache', cache_path, card, tmp)
        torch.cuda.empty_cache()
        timed('two_ranks', distributed_path, card, tmp, blob, cached)
    torch.cuda.empty_cache()
    t = timed('time_gates', time_gates, card, errs)
    tw = timed('time_warp', time_warp, card, warp_err)
    timed('time_launch_host', time_launch_host, card)
    timed('time_train_parts', time_train_parts, card)

    kernels = [{
        'name': 'attention_gate',
        'route': 'cuda',
        'source': 'unet_tpu_torch/csrc/attention_gate.cu',
        'replaces': 'unet_tpu/ops/pallas/attention_gate.py:160',
        'launches': launches,
        'max_abs_err': t['max_abs_err'],
        'ms': t['ms'],
        'plain_ms': t['plain_ms'],
        'bound_ms': t['bound_ms'],
        'bound_by': t['bound_by'],
        'library_ms': None,  # no single PyTorch call computes the gate
    }, {
        'name': 'warp',
        'route': 'cuda',
        'source': 'unet_tpu_torch/csrc/warp.cu',
        'replaces': 'unet_tpu/ops/pallas/warp.py:289',
        'launches': warp_launches,
        'max_abs_err': tw['max_abs_err'],
        'ms': tw['ms'],
        'plain_ms': tw['plain_ms'],
        'bound_ms': tw['bound_ms'],
        'bound_by': tw['bound_by'],
        # F.grid_sample blends an out-of-range tap as zero where this
        # function zeroes the whole pixel, and has no nearest-mask tie
        # rule: no single PyTorch call computes the warp
        'library_ms': None,
    }, {
        'name': 'conv3x3',
        'route': 'cuda',
        'source': 'unet_tpu_torch/csrc/conv3x3.cu',
        'replaces': 'unet_tpu/ops/pallas/conv3x3.py:174',
        'launches': tc['launches'],
        'max_abs_err': tc['max_abs_err'],
        'ms': tc['ms'],
        'plain_ms': tc['plain_ms'],
        'bound_ms': tc['bound_ms'],
        'bound_by': tc['bound_by'],
        'library_ms': tc['library_ms'],  # F.conv2d (cuDNN), bf16
    }]
    log('phase seconds (host clock): ' + json.dumps(PHASE_SECONDS))
    log(f'(kernel times: the four 512^2 gates of one bf16 forward at batch '
        f'{BATCH}, summed; the warp of one {SUPER}x{IMG}^2 super-batch; the '
        f'{N_CONVS} eligible 3x3 convs of one bf16 forward at batch {BATCH}, '
        f'summed; total run {time.perf_counter() - t_start:.1f} s)')
    log(card)  # as nvidia-smi prints it: name, power limit
    log(json.dumps({'kernels': kernels}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    if sys.argv[1:2] == ['--dist-worker']:
        sys.exit(dist_worker(sys.argv[2:]))
    if sys.argv[1:2] == ['--inference-ab']:
        sys.exit(inference_ab(sys.argv[2], int(sys.argv[3])))
    if sys.argv[1:2] == ['--memory-ceiling']:
        sys.exit(memory_ceiling())
    sys.exit(main())
