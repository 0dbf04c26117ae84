#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``unet_tpu_torch``) on one card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero, printing no result):

1. build the hand-written CUDA kernels from ``unet_tpu_torch/csrc`` with
   nvcc (sm_90a) and print the card's name and power limit;
2. hold each kernel against its plain PyTorch version at the shapes the
   main path gives it, in float32 and bfloat16;
3. AttentionUNet-64 at 512^2, batch 8, bf16, channels_last, random
   weights from a seed and calibrated BatchNorm statistics: the fused
   gate launches 4 kernels per forward, and its logits match the same
   weights with the fused gate off;
4. the main path: ``create_server`` serving that model (saved as a
   reference-format .pt) to concurrent HTTP clients, with the kernel
   launch count read around the run;
5. times (CUDA events) of each kernel beside its bound and plain version,
   of the model forward, and of serving.

The line before the last lists the kernels as JSON, and the last line is
``{"ok": true, "device": {...}}``. Exits 2 when no CUDA device is
available. Imports nothing of JAX or of the JAX package.
"""

import http.client
import io
import json
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


def log(*a):
    print(*a, flush=True)


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

def gate_inputs(cg, h, cx, inter, dtype, seed):
    """Random folded-gate arguments on the card, weights ~ 1/sqrt(fan_in)
    so the pre-activations are O(1) and the sigmoid is not saturated."""
    import torch
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    dev, cl = DEVICE, torch.channels_last

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    g = rnd(BATCH, cg, h, h).to(dtype=dtype, memory_format=cl)
    x = rnd(BATCH, cx, 2 * h, 2 * h).to(dtype=dtype, memory_format=cl)
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
    return errs


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
        sizes = [(512, 512), (400, 300), (256, 256), (600, 520),
                 (512, 384), (333, 517), (128, 200), (700, 700)]
        bodies = [(s, _png(_image(rng, *s))) for s in sizes]
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
    total['max_abs_err'] = max(e for (i, n), e in errs.items()
                               if n == 'bfloat16')
    return total


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
    log(f'built {", ".join(built)} in {time.perf_counter() - t0:.1f} s')
    for name in built:
        for line in (_build.BUILD / f'{name}.log').read_text().splitlines():
            if 'registers' in line or 'spill' in line:
                log(f'  ptxas {name}: {line.strip()}')

    errs = check_gates()
    model, _ = check_model(card)
    launches = serve_main_path(model, card)
    del model
    torch.cuda.empty_cache()
    t = time_gates(card, errs)

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
    }]
    log(f'(kernel times: the four 512^2 gates of one bf16 forward at batch '
        f'{BATCH}, summed; total run {time.perf_counter() - t_start:.1f} s)')
    log(card)  # as nvidia-smi prints it: name, power limit
    log(json.dumps({'kernels': kernels}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
