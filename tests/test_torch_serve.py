"""The port's serving path (unet_tpu_torch/cli/serve.py and the predict
steps of unet_tpu_torch/train/trainer.py) against the JAX package's, on
one reference-format .pt written by the JAX package. Both load it in
float32 (``tpu.compute_dtype``); the port also honours
``tpu.fused_attention_gate`` and so runs its fused gate route (the
kernel's plain version, on the CPU) at the last decoder level."""

import http.client
import io
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from unet_tpu.cli import predict as jpredict
from unet_tpu.cli import serve as jserve
from unet_tpu.models import create_model as jax_create_model
from unet_tpu.train import trainer as jtrainer
from unet_tpu.utils.torch_port import save_torch_checkpoint
from unet_tpu_torch.cli import predict, serve
from unet_tpu_torch.models import create_model
from unet_tpu_torch.ops.bitpack import unpack_masks_host
from unet_tpu_torch.train import trainer
from unet_tpu_torch.utils.torch_port import state_dict_from_jax

from torch_port_helpers import jax_variables

torch.set_num_threads(2)

IMG = 64   # the last gate (g 32^2 -> x 64^2) passes the fused guard
NEAR = 1e-5  # tumor probabilities this close to a threshold may flip
CFG = {'model': {'type': 'attention_unet', 'n_channels': 1, 'n_classes': 2,
                 'bilinear': True, 'base_features': 4,
                 'deep_supervision': False},
       'tpu': {'compute_dtype': 'float32', 'fused_attention_gate': True}}


@pytest.fixture(scope='module')
def checkpoint(tmp_path_factory):
    jm = jax_create_model('attention_unet', base_features=4)
    variables = jax_variables(jm, seed=7)
    # a random model's logits barely vary over an image: widen the head
    # and centre it, so tumor probabilities spread around 0.5
    head = variables['params']['outc']['conv']
    head['kernel'] *= 200.0
    model = create_model('attention_unet', base_features=4)
    model.load_state_dict(state_dict_from_jax(variables))
    u8 = np.random.default_rng(0).integers(0, 256, (2, 1, IMG, IMG))
    with torch.no_grad():
        logits = model.eval()(torch.from_numpy((u8 / 255.0 - 0.5) / 0.5))
    head['bias'][1] -= float((logits[:, 1] - logits[:, 0]).median())
    path = tmp_path_factory.mktemp('torch_serve') / 'model.pt'
    save_torch_checkpoint(path, variables, config=CFG, epoch=3)
    return path


@pytest.fixture(scope='module')
def jax_probs(checkpoint):
    """Tumor probabilities of the JAX model for (N, H, W, 1) uint8."""
    model, v, _ = jpredict.load_model(checkpoint)
    step = jax.jit(jtrainer.make_predict_step_u8(model))
    return lambda u8: np.asarray(
        step(v['params'], v['batch_stats'], jnp.asarray(u8))[..., 1])


@pytest.mark.parametrize('kind', ['serve', 'predict'])
def test_masks_step_matches_jax(kind, checkpoint, jax_probs):
    """Packed masks equal the JAX step's, except at pixels whose f32
    tumor probability lies within NEAR of the threshold (counted)."""
    factory = {'serve': 'make_serve_masks_step',
               'predict': 'make_predict_masks_step'}[kind]
    rng = np.random.default_rng(11)
    u8 = rng.integers(0, 256, (3, IMG, IMG, 1), dtype=np.uint8)
    thr = np.asarray([0.3, 0.5, 0.7], np.float32)

    jm, v, _ = jpredict.load_model(checkpoint)
    want = np.asarray(jax.jit(getattr(jtrainer, factory)(jm))(
        v['params'], v['batch_stats'], jnp.asarray(u8), jnp.asarray(thr)))
    model, meta = predict.load_model(checkpoint, device='cpu')
    assert meta['epoch'] == 3
    got = getattr(trainer, factory)(model)(
        torch.from_numpy(u8).permute(0, 3, 1, 2), torch.from_numpy(thr))
    got = got.numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape

    prob = jax_probs(u8)                                  # (N, H, W)
    if kind == 'serve':
        near = np.abs(prob - thr[:, None, None]) < NEAR
    else:                                                 # (T, N, H, W)
        near = np.abs(prob[None] - thr[:, None, None, None]) < NEAR
    bits = unpack_masks_host(got, IMG)
    assert 0.1 < bits.mean() < 0.9
    differ = bits != unpack_masks_host(want, IMG)
    assert not (differ & ~near).any()
    assert near.sum() < 0.001 * near.size  # ties stay rare


# ---------------------------------------------------------------- HTTP

@pytest.fixture(scope='module')
def servers(checkpoint):
    """The JAX server and the port's (on the CPU), each on a free port."""
    pairs = [jserve.create_server(checkpoint, img_size=IMG, max_batch=2,
                                  batch_window_ms=5.0, port=0),
             serve.create_server(checkpoint, img_size=IMG, max_batch=2,
                                 batch_window_ms=5.0, port=0, device='cpu')]
    for server, _ in pairs:
        threading.Thread(target=server.serve_forever, daemon=True).start()
    yield [f'127.0.0.1:{s.server_address[1]}' for s, _ in pairs]
    for server, batcher in pairs:
        server.shutdown()
        batcher.close()
        server.server_close()


def _request(addr, method, path, body=None):
    conn = http.client.HTTPConnection(addr, timeout=60)
    try:
        conn.request(method, path, body=body)
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        conn.close()


def _png(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format='PNG')
    return buf.getvalue()


def _near_at_original(body, thr, jax_probs):
    """Pixels of the original-size mask whose network-size probability
    lies within NEAR of thr (restored with NEAREST, as the servers do)."""
    x, orig = jpredict.preprocess_image(io.BytesIO(body), IMG)
    near = np.abs(jax_probs(x[None])[0] - thr) < NEAR
    m = Image.fromarray(near.astype(np.uint8))
    return np.asarray(m.resize(orig, Image.NEAREST)) > 0


@pytest.mark.parametrize('hw', [(40, 48), (64, 64), (90, 70)])
def test_http_masks_agree_with_jax_server(hw, servers, jax_probs):
    rng = np.random.default_rng(hw[0])
    body = _png((rng.random(hw) * 255).astype(np.uint8))
    near = _near_at_original(body, 0.5, jax_probs)
    masks = []
    for addr in servers:
        status, headers, data = _request(addr, 'POST', '/predict', body)
        assert status == 200 and headers['Content-Type'] == 'image/png'
        m = np.asarray(Image.open(io.BytesIO(data)))
        assert m.shape == hw and set(np.unique(m)) <= {0, 255}
        assert int(headers['X-Tumor-Pixels']) == int((m > 127).sum())
        masks.append(m)
    assert 0.1 < (masks[1] > 0).mean() < 0.9
    assert not ((masks[0] != masks[1]) & ~near).any()


def test_http_json_threshold_and_metrics_agree(servers, jax_probs):
    rng = np.random.default_rng(21)
    body = _png((rng.random((IMG, IMG)) * 255).astype(np.uint8))
    near = _near_at_original(body, 0.3, jax_probs)
    recs = [json.loads(_request(a, 'POST', '/predict?format=json'
                                '&threshold=0.3', body)[2]) for a in servers]
    assert recs[0].keys() == recs[1].keys()
    for key in ('width', 'height', 'threshold'):
        assert recs[0][key] == recs[1][key]
    assert 0 < recs[1]['tumor_pixels'] < IMG * IMG
    assert abs(recs[0]['tumor_pixels'] - recs[1]['tumor_pixels']) \
        <= near.sum()
    for addr in servers:  # one bad request each
        assert _request(addr, 'POST', '/predict', b'junk')[0] == 400

    metrics = [json.loads(_request(a, 'GET', '/metrics')[2])
               for a in servers]
    for key in ('requests_total', 'request_errors_total'):
        assert metrics[0][key] == metrics[1][key]
    assert metrics[0]['batcher']['rows_real'] == \
        metrics[1]['batcher']['rows_real']
    b = metrics[1]['batcher']
    assert sum(b['fill']) == b['dispatches'] >= 1
    assert sum(k * c for k, c in enumerate(b['fill'])) == b['rows_real']


def test_http_healthz_and_bad_requests(servers):
    status, _, data = _request(servers[1], 'GET', '/healthz')
    health = json.loads(data)
    assert status == 200 and health['status'] == 'ok'
    assert health['img_size'] == IMG and health['backend'] == 'cpu'
    assert health['epoch'] == 3
    addr = servers[1]
    assert _request(addr, 'POST', '/predict', b'')[0] == 400
    assert _request(addr, 'POST', '/predict?threshold=abc',
                    _png(np.zeros((8, 8), np.uint8)))[0] == 400
    assert _request(addr, 'GET', '/nope')[0] == 404
    assert _request(addr, 'POST', '/nope', b'x')[0] == 404


def test_microbatcher_batches_concurrent_requests():
    """4 submits inside the window share ONE predict call, and each
    caller gets its own row back."""
    calls = []

    def fake_predict(batch, thr):
        calls.append(batch.shape[0])
        assert thr.shape == (batch.shape[0],)
        return batch[:, 0] * 2.0

    b = serve.MicroBatcher(fake_predict, max_batch=4, window_s=0.5)
    outs = [None] * 4

    def call(i):
        outs[i] = b.submit(np.full((1, 2, 2), i, np.float32), timeout=10.0)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(15.0)
        assert not t.is_alive()
    b.close()
    assert calls == [4]
    for i in range(4):
        np.testing.assert_array_equal(outs[i], np.full((2, 2), 2.0 * i))


def test_create_server_needs_cuda_unless_told_cpu(checkpoint):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='CUDA'):
        serve.create_server(checkpoint, img_size=IMG, port=0)


def test_load_model_refuses_orbax_directories(tmp_path):
    with pytest.raises(ValueError, match='export_torch'):
        predict.load_model(tmp_path, device='cpu')
