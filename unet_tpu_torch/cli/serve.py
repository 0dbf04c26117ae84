#!/usr/bin/env python
"""Batched segmentation inference server on one GPU.

Counterpart of ``unet_tpu/cli/serve.py``, with the same flags and HTTP
API plus ``--device``:

- requests are padded into one fixed ``(max_batch, 1, img, img)`` uint8
  batch, so every dispatch has the same shapes;
- micro-batching: requests that arrive within ``--batch-window-ms`` of
  each other share one device dispatch;
- normalization, softmax and per-request thresholding run on the device
  and only bit-packed 1-bit masks are read back; masks are restored to
  each request's original size with NEAREST on the host.

Run: ``python -m unet_tpu_torch.cli.serve --weights model.pt --img-size 512``

API:
  GET  /healthz            -> 200 JSON {status, epoch, img_size, ...}
  GET  /metrics            -> 200 JSON: requests_total, mean/max latency
                              and the batcher's dispatch/fill-histogram/
                              padding/device-time counters. A request's
                              counters commit just before its first
                              response byte, so latency excludes sending
                              the response.
  POST /predict            -> body: PNG/JPEG bytes; response: PNG mask
                              (uint8 {0,255}, original size) with
                              X-Tumor-Coverage / X-Tumor-Pixels headers
  POST /predict?format=json-> JSON {tumor_pixels, coverage, width,
                              height, threshold} (no mask payload)
  optional query threshold=0.x overrides the server default per request
"""

import argparse
import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Serve tumor segmentation')
    p.add_argument('--weights', type=str, required=True,
                   help='reference-format torch .pt checkpoint')
    p.add_argument('--host', type=str, default='127.0.0.1')
    p.add_argument('--port', type=int, default=8500)
    p.add_argument('--img-size', type=int, default=512,
                   help='network input size (use the training size!)')
    p.add_argument('--threshold', type=float, default=0.5)
    p.add_argument('--max-batch', type=int, default=8,
                   help='dispatch batch size; requests arriving together '
                        'share one device dispatch up to this many')
    p.add_argument('--batch-window-ms', type=float, default=5.0,
                   help='how long the batcher waits for co-travellers '
                        'after the first request of a batch')
    p.add_argument('--device', type=str, default=None,
                   help='torch device (default: cuda)')
    return p.parse_args(argv)


class MicroBatcher:
    """Collects concurrent requests into fixed-shape device batches.

    ``submit`` blocks the calling (HTTP handler) thread until its result
    is ready; one worker thread drains the queue, waits up to
    ``window_s`` for co-travellers (up to ``max_batch``), pads the batch
    and its per-request threshold vector to the fixed shape, runs
    ``predict_fn`` once, and fans the per-row packed masks back out."""

    def __init__(self, predict_fn, max_batch: int, window_s: float):
        self._predict = predict_fn
        self._max_batch = max(1, int(max_batch))
        self._window = max(0.0, float(window_s))
        self._q = queue.Queue()
        self._stopping = threading.Event()
        # fill[k] = number of dispatches that carried k real requests
        self._stats_lock = threading.Lock()
        self._stats = {'dispatches': 0, 'rows_real': 0, 'rows_padded': 0,
                       'errors': 0, 'device_s': 0.0,
                       'fill': [0] * (self._max_batch + 1)}
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def snapshot(self) -> dict:
        with self._stats_lock:
            s = dict(self._stats)
            s['fill'] = list(s['fill'])
        s['max_batch'] = self._max_batch
        s['window_ms'] = self._window * 1e3
        if s['dispatches']:
            s['mean_fill'] = s['rows_real'] / s['dispatches']
            s['pad_fraction'] = s['rows_padded'] / (
                s['rows_real'] + s['rows_padded'])
            s['mean_device_ms'] = 1e3 * s['device_s'] / s['dispatches']
        return s

    def submit(self, x: np.ndarray, threshold: float = 0.5,
               timeout: float = 60.0) -> np.ndarray:
        """x: one request's raw input row (e.g. (1, H, W) uint8);
        threshold: its tumor-probability cut. Returns that row of
        ``predict_fn``'s output (the (H, ceil(W/8)) bit-packed mask).
        Raises on worker failure or timeout."""
        ev = threading.Event()
        slot = {'ev': ev, 'x': x, 'thr': float(threshold)}
        self._q.put(slot)
        if not ev.wait(timeout):
            slot['dead'] = True  # worker discards late results
            raise TimeoutError('prediction timed out')
        if 'err' in slot:
            raise slot['err']
        return slot['out']

    def close(self):
        self._stopping.set()
        self._q.put(None)  # unblock the worker
        self._worker.join(timeout=5.0)

    # -- worker side ---------------------------------------------------

    def _collect(self):
        """One batch: block for the first request, then gather
        co-travellers inside the window."""
        first = self._q.get()
        if first is None:
            return None
        slots = [first]
        deadline = time.monotonic() + self._window
        while len(slots) < self._max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:
                break
            slots.append(item)
        return slots

    def _run(self):
        while not self._stopping.is_set():
            slots = self._collect()
            if not slots:
                continue
            try:
                xs = [s['x'] for s in slots]
                thrs = [s['thr'] for s in slots]
                n = len(xs)
                while len(xs) < self._max_batch:  # pad to the fixed shape
                    xs.append(xs[-1])
                    thrs.append(thrs[-1])
                t0 = time.monotonic()
                outs = np.asarray(self._predict(
                    np.stack(xs), np.asarray(thrs, np.float32)))
                dt = time.monotonic() - t0
                with self._stats_lock:
                    st = self._stats
                    st['dispatches'] += 1
                    st['rows_real'] += n
                    st['rows_padded'] += self._max_batch - n
                    st['device_s'] += dt
                    st['fill'][n] += 1
                for i, s in enumerate(slots):
                    if not s.get('dead'):
                        s['out'] = outs[i]
            except Exception as e:  # handed to every waiting request
                with self._stats_lock:
                    self._stats['errors'] += 1
                for s in slots:
                    if not s.get('dead'):
                        s['err'] = e
            for s in slots:
                s.pop('x', None)
                s['ev'].set()
            del slots


def _make_handler(batcher: MicroBatcher, img_size: int,
                  default_threshold: float, health: dict):
    from PIL import Image

    from unet_tpu_torch.data.cache import native_decode_mem
    from unet_tpu_torch.ops.bitpack import unpack_masks_host

    req_lock = threading.Lock()
    req_stats = {'requests': 0, 'errors': 0, 'latency_s': 0.0,
                 'latency_max_s': 0.0, 'started': time.monotonic()}

    def record_request(t0: float, ok: bool):
        dt = time.monotonic() - t0
        with req_lock:
            req_stats['requests'] += 1
            if not ok:
                req_stats['errors'] += 1
            req_stats['latency_s'] += dt
            req_stats['latency_max_s'] = max(req_stats['latency_max_s'], dt)

    class Handler(BaseHTTPRequestHandler):
        protocol_version = 'HTTP/1.1'

        def log_message(self, fmt, *a):  # quiet by default
            pass

        def _send(self, code, body: bytes, ctype='application/json',
                  headers=()):
            # commit request stats BEFORE the first response byte, so a
            # client that got its response never sees /metrics miss it
            if getattr(self, '_stats_t0', None) is not None:
                record_request(self._stats_t0, code < 400)
                self._stats_t0 = None
            self.send_response(code)
            self.send_header('Content-Type', ctype)
            self.send_header('Content-Length', str(len(body)))
            if code >= 400:
                # error paths may leave request-body bytes unread; a
                # keep-alive client would misparse the stream, so close
                self.close_connection = True
                self.send_header('Connection', 'close')
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code, obj, headers=()):
            self._send(code, json.dumps(obj).encode(), headers=headers)

        def do_GET(self):
            path = urlparse(self.path).path
            if path == '/healthz':
                self._send_json(200, health)
            elif path == '/metrics':
                with req_lock:
                    http_stats = dict(req_stats)
                n = http_stats.pop('requests')
                errs = http_stats.pop('errors')
                rec = {
                    'requests_total': n,
                    'request_errors_total': errs,
                    'uptime_s': round(
                        time.monotonic() - http_stats['started'], 1),
                    'mean_latency_ms': round(
                        1e3 * http_stats['latency_s'] / n, 2) if n else 0.0,
                    'max_latency_ms': round(
                        1e3 * http_stats['latency_max_s'], 2),
                    'batcher': batcher.snapshot(),
                }
                self._send_json(200, rec)
            else:
                self._send_json(404, {'error': 'not found'})

        def do_POST(self):
            self._stats_t0 = time.monotonic()
            try:
                self._handle_predict()
            finally:
                if self._stats_t0 is not None:
                    # the handler died before responding: count an error
                    record_request(self._stats_t0, False)
                    self._stats_t0 = None

        def _handle_predict(self):
            url = urlparse(self.path)
            if url.path != '/predict':
                self._send_json(404, {'error': 'not found'})
                return
            q = parse_qs(url.query)
            length = int(self.headers.get('Content-Length') or 0)
            if length <= 0:
                self._send_json(400, {'error': 'empty body'})
                return
            if length > 64 << 20:
                self._send_json(413, {'error': 'body too large'})
                return
            raw = self.rfile.read(length)  # drain BEFORE any 4xx reply
            try:
                thr = float(q.get('threshold', [default_threshold])[0])
            except ValueError:
                self._send_json(400, {'error': 'bad threshold'})
                return
            # grayscale PNGs decode+resize natively (PIL-bit-exact);
            # other bodies fall back to PIL, which also raises the 400
            # for corrupt input
            dec = native_decode_mem(raw, img_size)
            if dec is not None:
                x8, orig_size = dec  # (W, H)
            else:
                try:
                    img = Image.open(io.BytesIO(raw)).convert('L')
                except Exception as e:
                    self._send_json(400,
                                    {'error': f'undecodable image: {e}'})
                    return
                orig_size = img.size  # (W, H)
                if img.size != (img_size, img_size):
                    img = img.resize((img_size, img_size), Image.BILINEAR)
                x8 = np.asarray(img, np.uint8)
            try:
                packed = batcher.submit(x8[None], threshold=thr)
            except Exception as e:
                self._send_json(500, {'error': f'{type(e).__name__}: {e}'})
                return
            mask = unpack_masks_host(packed, img_size) * np.uint8(255)
            m = Image.fromarray(mask)
            if m.size != orig_size:  # NEAREST restore to the original
                m = m.resize(orig_size, Image.NEAREST)
            arr = np.asarray(m)
            tumor_px = int((arr > 127).sum())
            coverage = tumor_px / arr.size
            if q.get('format', ['png'])[0] == 'json':
                self._send_json(200, {
                    'tumor_pixels': tumor_px,
                    'coverage': coverage,
                    'width': int(orig_size[0]),
                    'height': int(orig_size[1]),
                    'threshold': thr,
                })
                return
            buf = io.BytesIO()
            # zlib level 1: lossless and 2-4x faster to encode than the
            # default; encode time is response latency here
            m.save(buf, format='PNG', compress_level=1)
            self._send(200, buf.getvalue(), ctype='image/png',
                       headers=(('X-Tumor-Pixels', str(tumor_px)),
                                ('X-Tumor-Coverage', f'{coverage:.6f}')))

    return Handler


def create_server(weights, img_size=512, threshold=0.5, max_batch=8,
                  batch_window_ms=5.0, host='127.0.0.1', port=8500,
                  device=None):
    """Build the (server, batcher) pair with the model loaded on
    ``device`` (CUDA unless the caller names another; raises when CUDA is
    absent) and warmed up at the serving shape, kernel builds included,
    before the socket opens. Separate from main() so tests can run it on
    port 0."""
    import torch

    from unet_tpu_torch.cli.predict import load_model
    from unet_tpu_torch.train.trainer import make_serve_masks_step

    model, meta = load_model(weights, device=device)
    dev = next(model.parameters()).device
    step = make_serve_masks_step(model)

    def predict(batch_np: np.ndarray, thr_np: np.ndarray) -> np.ndarray:
        u8 = torch.from_numpy(batch_np).to(dev)
        thr = torch.from_numpy(thr_np).to(dev)
        # (N, H, ceil(W/8)) uint8; .cpu() waits for the device
        return step(u8, thr).cpu().numpy()

    predict(np.zeros((max_batch, 1, img_size, img_size), np.uint8),
            np.full((max_batch,), 0.5, np.float32))
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)

    batcher = MicroBatcher(predict, max_batch, batch_window_ms / 1e3)
    health = {
        'status': 'ok',
        'weights': str(weights),
        'epoch': meta.get('epoch'),
        'img_size': img_size,
        'max_batch': max_batch,
        'backend': dev.type,
        'device': (torch.cuda.get_device_name(dev) if dev.type == 'cuda'
                   else str(dev)),
        'data_parallel': 1,
    }
    handler = _make_handler(batcher, img_size, threshold, health)
    try:
        server = ThreadingHTTPServer((host, port), handler)
    except OSError:
        batcher.close()
        raise
    return server, batcher


def main(argv=None):
    args = parse_args(argv)
    print(f'Loading {args.weights} (batch={args.max_batch} '
          f'@ {args.img_size}px)...')
    server, batcher = create_server(
        args.weights, img_size=args.img_size, threshold=args.threshold,
        max_batch=args.max_batch, batch_window_ms=args.batch_window_ms,
        host=args.host, port=args.port, device=args.device)
    print(f'Serving on http://{args.host}:{server.server_address[1]} '
          f'(POST /predict, GET /healthz, GET /metrics)')
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        batcher.close()
        server.server_close()


if __name__ == '__main__':
    main()
