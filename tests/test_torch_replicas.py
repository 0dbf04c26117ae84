"""The port's data-parallel inference in one process
(unet_tpu_torch/core/mesh.py: ``inference_devices``, ``ReplicaSet``) on
the CPU, through ``create_server``'s HTTP path and the predict CLI's
directory pipeline, on a replica list that repeats the CPU, so the split,
the per-replica steps and the join in row order run for real. A row's
result may depend on the batch size it is computed in (its float sums
are ordered by the batch's blocking: up to 3e-8 in a logit here), so
k replicas of a batch of B rows are held bit for bit against one
device computing blocks of B / k rows, which is each replica's work."""

import http.client
import io
import json
import threading

import numpy as np
import pytest
import torch
from PIL import Image

torch.set_num_threads(2)

IMG = 64
CFG = {'model': {'type': 'attention_unet', 'n_channels': 1, 'n_classes': 2,
                 'bilinear': True, 'base_features': 4,
                 'deep_supervision': False},
       'tpu': {'compute_dtype': 'float32', 'fused_attention_gate': True}}


def _image(rng, h, w):
    small = (rng.random((max(2, h // 8), max(2, w // 8))) * 255)
    return Image.fromarray(small.astype(np.uint8)).resize((w, h),
                                                          Image.BILINEAR)


@pytest.fixture(scope='module')
def checkpoint(tmp_path_factory):
    """A seeded AttentionUNet-4 whose head is widened and centred, so
    tumor probabilities spread around 0.5, and a directory of PNGs."""
    from unet_tpu_torch.models import create_model
    model = create_model('attention_unet', base_features=4,
                         generator=torch.Generator().manual_seed(2)).eval()
    u8 = np.random.default_rng(0).integers(0, 256, (2, 1, IMG, IMG))
    with torch.no_grad():
        model.outc.conv.weight[1] *= 50.0
        logits = model(torch.from_numpy((u8 / 255.0 - 0.5) / 0.5).float())
        model.outc.conv.bias[1] -= float(
            (logits[:, 1] - logits[:, 0]).median())
    tmp = tmp_path_factory.mktemp('replicas')
    pt = tmp / 'model.pt'
    torch.save({'epoch': 2, 'model_state_dict': model.state_dict(),
                'optimizer_state_dict': {}, 'metrics': {}, 'config': CFG},
               pt)
    rng = np.random.default_rng(1)
    src = tmp / 'imgs'
    src.mkdir()
    for i, (h, w) in enumerate([(64, 64), (50, 80), (96, 72), (64, 64),
                                (40, 40), (70, 60), (64, 100)]):
        _image(rng, h, w).save(src / f'slice_{i}.png')
    return {'pt': pt, 'src': src, 'tmp': tmp}


def test_inference_devices(monkeypatch):
    from unet_tpu_torch.core.mesh import inference_devices
    cpu = torch.device('cpu')
    assert inference_devices('cpu') == [cpu]
    assert inference_devices(['cpu', 'cpu']) == [cpu, cpu]
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for device in (None, 'cuda', ['cpu', 'cuda:0']):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            inference_devices(device)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 3)
    assert inference_devices(None) == [torch.device('cuda', i)
                                       for i in range(3)]
    assert inference_devices('cuda:1') == [torch.device('cuda', 1)]


@pytest.mark.parametrize('kind', ['serve', 'predict'])
def test_replica_set_joins_rows_in_order(checkpoint, kind):
    from unet_tpu_torch.cli.predict import load_model
    from unet_tpu_torch.core.mesh import ReplicaSet
    from unet_tpu_torch.train import trainer
    model, _ = load_model(checkpoint['pt'], device='cpu')
    make_step, per_row = {
        'serve': (trainer.make_serve_masks_step, True),
        'predict': (trainer.make_predict_masks_step, False)}[kind]
    u8 = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (6, 1, IMG, IMG), dtype=np.uint8))
    thr = torch.tensor([0.3, 0.5, 0.7, 0.4, 0.5, 0.6] if per_row
                       else [0.3, 0.5, 0.7])
    one = ReplicaSet(model, ['cpu'], make_step, per_row)
    for n in (2, 3):
        b = 6 // n
        want = torch.cat([one.run(u8[i:i + b], thr[i:i + b] if per_row
                                  else thr).wait()
                          for i in range(0, 6, b)], 0 if per_row else 1)
        replicas = ReplicaSet(model, ['cpu'] * n, make_step, per_row)
        assert len(replicas) == n
        got = replicas.run(u8, thr).wait()
        assert torch.equal(got, want), n
        assert 0 < np.unpackbits(want.numpy()).mean() < 1
    with pytest.raises(ValueError, match='split'):
        ReplicaSet(model, ['cpu'] * 4, make_step, per_row).run(u8, thr)


def _request(addr, method, path, body=None):
    conn = http.client.HTTPConnection(*addr, timeout=60)
    try:
        conn.request(method, path, body=body)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _serve(checkpoint, devices, max_batch, bodies):
    """Health and the PNG responses to ``bodies`` sent at once (a long
    batch window, so they tend to share dispatches)."""
    from unet_tpu_torch.cli.serve import create_server
    server, batcher = create_server(checkpoint['pt'], img_size=IMG,
                                    max_batch=max_batch,
                                    batch_window_ms=300, port=0,
                                    devices=devices)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    addr = server.server_address[:2]
    try:
        health = json.loads(_request(addr, 'GET', '/healthz')[1])
        out = [None] * len(bodies)

        def client(i):
            out[i] = _request(addr, 'POST', '/predict', bodies[i])

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
        return health, out
    finally:
        server.shutdown()
        batcher.close()
        server.server_close()
        thread.join(5)


@pytest.mark.parametrize('max_batch,replicas', [(4, 2), (3, 1)])
def test_server_splits_each_dispatch_over_the_replicas(checkpoint,
                                                       max_batch, replicas):
    """``max_batch`` even: two replicas, ``data_parallel`` 2, and the
    served masks byte-equal to one device's at the replicas' batch
    (``max_batch // 2``); odd: one device serves, as the JAX server
    falls back when the batch does not split."""
    rng = np.random.default_rng(4)
    bodies = []
    for h, w in [(64, 64), (50, 80), (96, 72), (40, 40), (70, 60)]:
        buf = io.BytesIO()
        _image(rng, h, w).save(buf, format='PNG')
        bodies.append(buf.getvalue())
    health, got = _serve(checkpoint, ['cpu', 'cpu'], max_batch, bodies)
    assert health['data_parallel'] == replicas
    _, want = _serve(checkpoint, ['cpu'], max_batch // replicas, bodies)
    for (status, body), (want_status, want_body) in zip(got, want):
        assert status == want_status == 200
        assert body == want_body
        assert np.asarray(Image.open(io.BytesIO(body))).any()


@pytest.mark.parametrize('batch,split', [(4, True), (3, False)])
def test_predict_pipeline_splits_batches(checkpoint, tmp_path, capsys,
                                         batch, split):
    """The directory pipeline over ``[cpu, cpu]``: a batch that splits
    is split (and printed so), and every PNG it writes is byte-identical
    to the one-device run's at the replicas' batch (the same chunks, each
    split in two)."""
    from unet_tpu_torch.cli.predict import parse_args, run_directory

    def run(out, devices, batch):
        args = parse_args(['--weights', str(checkpoint['pt']), '--source',
                           str(checkpoint['src']), '--output', str(out),
                           '--img-size', str(IMG), '--threshold',
                           '0.4,0.5,0.6', '--batch-size', str(batch),
                           '--save-overlay', '--device', 'cpu'])
        summary = run_directory(args, [torch.device(d) for d in devices])
        return summary, capsys.readouterr().out

    summary, log = run(tmp_path / 'two', ['cpu', 'cpu'], batch)
    assert ('Sharding batches over 2 devices' in log) == split
    assert summary['processed'] == 7
    _, log = run(tmp_path / 'one', ['cpu'], batch // 2 if split else batch)
    assert 'Sharding' not in log
    names = sorted(p.name for p in (tmp_path / 'one').iterdir())
    assert names == sorted(p.name for p in (tmp_path / 'two').iterdir())
    assert len(names) == 7 * 4
    for name in names:
        assert ((tmp_path / 'two' / name).read_bytes()
                == (tmp_path / 'one' / name).read_bytes()), name


def test_spatial_shard_on_one_device_runs_the_normal_path(checkpoint,
                                                          tmp_path,
                                                          capsys):
    """As JAX's CLI: with one device --spatial-shard changes nothing."""
    from unet_tpu_torch.cli.predict import main
    main(['--weights', str(checkpoint['pt']), '--source',
          str(checkpoint['src']), '--output', str(tmp_path), '--img-size',
          str(IMG), '--spatial-shard', '--device', 'cpu'])
    log = capsys.readouterr().out
    assert 'Sharding' not in log and 'Processed 7/7' in log
