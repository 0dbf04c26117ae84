"""TransUNet R50-ViT-B/16 (``unet_tpu_torch/models/transunet.py``) against
its plain reference (``tests/plain_transunet.py``, the published forward
in plain float32 PyTorch) on seeded weights, at a small size on the CPU:
img 64, hidden 64, 2 layers of 4 heads, MLP 128, ResNet units (1, 1, 1)
of width 32 (GroupNorm(32) still divides every width), decoder (32, 16,
8, 8), so 16 tokens.

Held here: the forward logits and one full ``TrainStep`` in float32; the
bfloat16 route within a bound that a float8 forward exceeds; dropout
replayed from one generator; the batched casts and gradient bucket bit
for bit against a cast and an accumulation a parameter; at the published
widths, on the ``meta`` device, the state dict, the operation count,
the 1024 tokens and the 127 -> 128 skip pad; the init; the attention
entry point and its count; the train and predict CLIs, and the spans.

Tests marked ``chip`` need the card and skip elsewhere. This file imports
no JAX, so they run on the card's machine without ``tests/conftest.py``:

    python -m pytest tests/test_torch_transunet.py --noconftest -m chip
"""

import copy
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from unet_tpu_torch.models import (TRANSUNET, create_model_from_config,
                                   init_parameters)
from unet_tpu_torch.models import transunet as tu
from unet_tpu_torch.models.layers import TorchBatchNorm
from unet_tpu_torch.ops import attention as attn_ops
from unet_tpu_torch.ops._build import launches
from unet_tpu_torch.utils import profiling
from unet_tpu_torch.utils.profiling import spans

sys.path.insert(0, str(Path(__file__).resolve().parent))
import plain_transunet as ref  # noqa: E402

torch.set_num_threads(2)

TINY = {'type': TRANSUNET, 'n_channels': 1, 'n_classes': 2, 'img_size': 64,
        'hidden_size': 64, 'num_layers': 2, 'num_heads': 4, 'mlp_dim': 128,
        'resnet_units': [1, 1, 1], 'resnet_width': 32,
        'decoder_channels': [32, 16, 8, 8], 'n_skip': 3,
        'dropout_rate': 0.0, 'attention_dropout_rate': 0.0}
PUBLISHED = {'type': TRANSUNET, 'n_channels': 1, 'n_classes': 2}
# the count from the layer equations: R50 41.0, embedding 1.6,
# transformer 212.6, decoder 81.1 GFLOP forward a 512^2 slice
PUBLISHED_GFLOP = 336.27


def _pair(cfg=TINY, seed=0, dtype=torch.float32):
    """The program (``dtype``) and the reference on one seeded state."""
    prog = create_model_from_config(cfg, dtype,
                                    generator=torch.Generator().manual_seed(
                                        seed))
    prog = prog.to(memory_format=torch.channels_last)
    net = ref.Net(cfg)
    net.load_state_dict(prog.state_dict())
    return prog, net


def _x(n=2, seed=1):
    return torch.randn(n, 1, 64, 64, generator=torch.Generator().manual_seed(
        seed))


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize('mode', ['train', 'eval'])
def test_forward_matches_the_plain_reference_in_float32(mode):
    prog, net = _pair()
    prog.train(mode == 'train')
    net.train(mode == 'train')
    x = _x()
    with torch.no_grad():
        got, want = prog(x), net(x)
    assert got.dtype == torch.float32 and got.shape == (2, 2, 64, 64)
    # float32 on both sides; the weight standardisation (a LayerNorm
    # against mean/sqrt), attention (SDPA's math backend against matmul,
    # softmax, matmul) and the convolutions sum in other orders: gaps of
    # ~2e-6 of the largest logit seen
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))


def test_one_train_step_matches_the_plain_reference_in_float32():
    """One TrainStep (microbatch 2 x accumulation 2, DiceBCE, clip 0.1,
    AdamW) against the same step by hand on the reference."""
    from unet_tpu_torch.train.losses import create_loss_function
    from unet_tpu_torch.train.trainer import (clip_by_global_norm,
                                              create_optimizer,
                                              make_train_step)
    prog, net = _pair(seed=3)
    init = {k: v.clone() for k, v in prog.state_dict().items()}
    loss_fn = create_loss_function('dice_bce')
    lr = 1e-3
    step = make_train_step(prog, loss_fn, create_optimizer(prog, lr),
                           accum_steps=2, grad_clip=0.1)
    imgs = torch.randn(2, 2, 1, 64, 64,
                       generator=torch.Generator().manual_seed(4))
    masks = (torch.rand(2, 2, 64, 64,
                        generator=torch.Generator().manual_seed(5))
             > 0.8).long()
    loss = step(imgs, masks, lr, [1, 1])
    grads = {k: p.grad.clone() for k, p in prog.named_parameters()}

    net.train()
    opt = torch.optim.AdamW(net.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4, foreach=False)
    want_loss = 0.0
    for a in range(2):
        out = loss_fn(net(imgs[a]), masks[a])
        out.backward()
        want_loss += float(out.detach())
    params = list(net.parameters())
    with torch.no_grad():
        for p in params:
            p.grad.div_(2)
        norm = clip_by_global_norm([p.grad for p in params], 0.1)
        want_grads = {k: p.grad.clone() for k, p in net.named_parameters()}
    assert float(norm) > 0.1   # the clip is in force
    opt.step()
    # float32 both; summation order only
    assert abs(float(loss) - want_loss) <= 1e-5 * abs(want_loss)
    for k, g in want_grads.items():
        # the clipped gradients, each leaf against its own largest element
        # (order of sums); the key biases' gradients are zero but for
        # rounding (softmax ignores a shift shared by all keys): 1e-9
        torch.testing.assert_close(grads[k], g, rtol=0,
                                   atol=1e-4 * float(g.abs().max()) + 1e-9,
                                   msg=k)
    now, want = prog.state_dict(), net.state_dict()
    for k, v in want.items():
        if k.endswith(('running_mean', 'running_var')):
            torch.testing.assert_close(now[k], v, rtol=1e-5, atol=1e-6,
                                       msg=k)
        elif k.endswith('num_batches_tracked'):
            assert int(now[k]) == int(v) == 2, k
        else:
            # AdamW's first step moves each element by about lr whatever
            # its gradient's size, so an element whose gradient lies at
            # rounding from zero may move the other way: within 2 lr
            torch.testing.assert_close(now[k], v, rtol=0, atol=2 * lr,
                                       msg=k)
            assert not torch.equal(now[k], init[k]), k


def test_bfloat16_route_is_within_its_bound_and_float8_is_not():
    """The program in bfloat16 against the float32 reference, logits in
    train mode: 0.019-0.022 relative (L2) over 4 seeds; the reference with
    float8 matrix operations 0.19-0.24. Bound 0.05."""
    for seed in (0, 1):
        prog, net = _pair(seed=seed, dtype=torch.bfloat16)
        fp8 = copy.deepcopy(net)
        ref.set_fp8(fp8, True)
        x = _x(seed=10 + seed)
        with torch.no_grad():
            want = net(x)
            got, low = prog(x), fp8(x)
        assert got.dtype == torch.float32
        assert _rel(got, want) < 0.05 < _rel(low, want), (
            seed, _rel(got, want), _rel(low, want))


def test_dropout_replays_from_one_generator():
    cfg = {**TINY, 'dropout_rate': 0.1}
    prog, net = _pair(cfg, seed=2)
    x = _x(seed=3)
    outs = []
    for model, setter in ((prog, tu.set_dropout_generator),
                          (net, ref.set_dropout_generator)):
        setter(model, torch.Generator().manual_seed(99))
        with torch.no_grad():
            outs.append(model.train()(x))
    # float32, as the forward test; the masks are the same draws
    torch.testing.assert_close(outs[0], outs[1], rtol=0,
                               atol=1e-4 * float(outs[1].abs().max()))
    tu.set_dropout_generator(prog, torch.Generator().manual_seed(98))
    with torch.no_grad():
        assert _rel(prog(x), outs[1]) > 1e-2   # the masks do something
    assert sum(isinstance(m, tu.Dropout) for m in prog.modules()) == 5


def test_batched_casts_and_gradient_bucket_are_bit_for_bit():
    """bf16: the batched casts and the gradient bucket against a cast and
    an accumulation a parameter, over two steps of two microbatches (the
    second step after a zero_grad)."""
    prog, _ = _pair(seed=4, dtype=torch.bfloat16)
    alone = copy.deepcopy(prog)
    batch = tu._BATCH_CAST
    for step in range(2):
        for model in (prog, alone):
            model.zero_grad(set_to_none=True)
        for mb in range(2):
            x = _x(seed=20 + 2 * step + mb)
            prog(x).square().mean().backward()
            tu._BATCH_CAST = ()
            try:
                alone(x).square().mean().backward()
            finally:
                tu._BATCH_CAST = batch
        for (k, p), q in zip(prog.named_parameters(), alone.parameters()):
            assert torch.equal(p.grad, q.grad), (step, k)
    bucket = prog._grad_bucket
    assert bucket.flat is not None and bucket.flat.dtype == torch.float32
    cast = [p for m in prog.modules() if isinstance(m, tu._BATCH_CAST)
            for p in m.parameters(recurse=False)]
    assert all(p.grad is v for p, v in zip(cast, bucket.views))
    assert copy.deepcopy(prog)._grad_bucket.flat is None


def test_published_widths_on_the_meta_device():
    with torch.device('meta'):
        prog = create_model_from_config(PUBLISHED, torch.bfloat16)
        net = ref.Net(PUBLISHED)
    got, want = prog.state_dict(), net.state_dict()
    assert list(got) == list(want)
    assert all(got[k].shape == want[k].shape for k in want)
    for name in ('transformer.embeddings.hybrid_model.body.block1.unit1.'
                 'conv1.weight', 'transformer.encoder.layer.0.attn.query.'
                 'weight', 'decoder.blocks.0.conv1.1.running_mean',
                 'segmentation_head.0.weight'):
        assert name in got
    assert got['transformer.embeddings.position_embeddings'].shape == (
        1, 1024, 768)
    assert prog.get_num_params() == 105911970
    flops = ref.flops_per_slice(PUBLISHED, 512)
    assert abs(flops / 1e9 - PUBLISHED_GFLOP) <= 0.002 * PUBLISHED_GFLOP
    assert ref.attention_flops_per_slice(512) == 4 * 1024 ** 2 * 768 * 12
    # the stage-1 map is 127^2 after the 3x3/2 pool and is kept padded to
    # 128^2; the skips are [512 @ 64^2, 256 @ 128^2, 64 @ 256^2]
    shapes = {}
    stage1 = prog.transformer.embeddings.hybrid_model.body.block1
    stage1.register_forward_hook(
        lambda m, i, o: shapes.update(stage1=tuple(o.shape)))
    with torch.device('meta'), torch.no_grad():
        x = torch.empty(1, 3, 512, 512, dtype=torch.bfloat16)
        tokens, skips = prog.transformer.embeddings(x)
    assert shapes['stage1'] == (1, 256, 127, 127)
    assert [tuple(s.shape) for s in skips] == [
        (1, 512, 64, 64), (1, 256, 128, 128), (1, 64, 256, 256)]
    assert tokens.shape == (1, 1024, 768)


def test_init_plan_gives_every_leaf_its_published_rule():
    with torch.device('meta'):
        shapes = {k: v.shape for k, v in ref.Net(PUBLISHED).state_dict()
                  .items()}
    plan = ref.init_plan(shapes)
    assert set(plan) == set(shapes)
    assert {v[0] for v in plan.values()} == {'uniform', 'normal', 'ones',
                                             'zeros'}
    layer = 'transformer.encoder.layer.3.'
    assert plan[layer + 'ffn.fc1.weight'] == ('uniform', (768 + 3072) / 6)
    assert plan[layer + 'ffn.fc2.bias'] == ('normal', 1e-6)
    assert plan[layer + 'attn.value.weight'] == ('uniform', 768)
    assert plan[layer + 'attn.value.bias'] == ('uniform', 768)
    assert plan[layer + 'ffn_norm.weight'] == ('ones',)
    assert plan['transformer.embeddings.position_embeddings'] == ('zeros',)
    assert plan['transformer.embeddings.patch_embeddings.bias'] == (
        'uniform', 1024)
    assert plan['segmentation_head.0.bias'] == ('uniform', 16 * 9)
    assert plan['transformer.embeddings.hybrid_model.root.conv.weight'] == (
        'uniform', 3 * 49)
    assert plan['decoder.conv_more.1.running_var'] == ('ones',)
    # the program's own init follows the same rules
    prog = create_model_from_config(TINY, torch.float32)
    with torch.no_grad():
        for m in prog.modules():
            if not isinstance(m, TorchBatchNorm):   # it keeps its own
                for p in m.parameters(recurse=False):
                    p.fill_(7.0)
    init_parameters(prog, torch.Generator().manual_seed(0))
    sd = prog.state_dict()
    for k, kind in ref.init_plan({k: v.shape for k, v in sd.items()}).items():
        v = sd[k].double()
        if kind[0] == 'uniform':
            bound = kind[1] ** -0.5
            assert v.abs().max() <= bound, k
            # a draw of 64 or more reaches past half its bound
            assert v.numel() < 64 or v.abs().max() > 0.5 * bound, k
        elif kind[0] == 'normal':
            assert 0 < v.abs().max() < 10 * kind[1], k
        else:
            assert torch.equal(v, torch.full_like(v, kind[0] == 'ones')), k


def test_attention_entry_point_is_softmax_qk_v_and_counts():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 3, 10, 8, generator=g) for _ in range(3))
    before = launches['attention']
    got = attn_ops.attention(q, k, v)
    assert launches['attention'] == before + 1
    want = torch.softmax(q @ k.transpose(-1, -2) / 8 ** 0.5, -1) @ v
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    prog, _ = _pair()
    before = launches['attention']
    with torch.no_grad():
        prog(_x())
    assert launches['attention'] == before + TINY['num_layers']


def test_config_validation():
    from unet_tpu_torch.utils.config import validate_config
    ok = {'model': {'type': TRANSUNET}, 'data': {'img_size': 64}}
    validate_config(ok)
    for bad in ({'model': {'type': TRANSUNET}, 'data': {'img_size': 72}},
                {'model': {'type': TRANSUNET, 'img_size': 128},
                 'data': {'img_size': 64}},
                {'model': {'type': TRANSUNET, 'deep_supervision': True},
                 'data': {'img_size': 64}}):
        with pytest.raises(ValueError):
            validate_config(bad)
    with pytest.raises(ValueError, match='divisible by 16'):
        create_model_from_config({**TINY, 'img_size': 72}, torch.float32)


# ---- the CLIs: 5 synthetic volumes of 4 slices (one for validation),
# microbatch 4 x accumulation 2, so 2 optimizer steps, augmentation on,
# float32, with the span recorder on

STEPS, ACCUM = 2, 2


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    from unet_tpu_torch.cli import train
    tmp = tmp_path_factory.mktemp('transunet')
    cfg = {
        'model': {k: v for k, v in TINY.items() if k != 'img_size'},
        'data': {'root': str(tmp / 'none'), 'img_size': 64,
                 'val_ratio': 0.2, 'batch_size': 4, 'num_workers': 2},
        'train': {'epochs': 1, 'lr': 0.001, 'weight_decay': 0.0001,
                  'grad_clip': 1.0, 'accumulation_steps': ACCUM},
        'scheduler': {'type': 'cosine_annealing', 'min_lr': 1e-6},
        'ema': {'enabled': False},
        'early_stopping': {'enabled': False},
        'loss': {'type': 'dice_bce', 'balanced_class_weight': 0.5,
                 'ce_weight': 1.0, 'dice_weight': 1.0},
        'augmentation': {'enabled': True},
        'output': {'save_dir': str(tmp / 'runs'), 'experiment_name': 'tu',
                   'save_last': True, 'save_best': False},
        'seed': 7, 'device': 'cpu', 'tpu': {'compute_dtype': 'float32'},
    }
    path = tmp / 'tu.yaml'
    path.write_text(yaml.safe_dump(cfg))
    spans.start()
    try:
        result = train.main(['--config', str(path), '--synthetic',
                             '--synthetic-volumes', '5',
                             '--synthetic-slices', '4'])
    finally:
        recorded = spans.stop()
    return tmp, result, recorded


def test_train_cli_trains_and_counts_attention(run):
    _, result, _ = run
    assert len(result['train_loss']) == 1
    assert np.isfinite(result['train_loss'][0])
    # 2 layers a forward: 2 steps x 2 microbatches, then the validation
    # forward of one batch
    counts = result['kernel_launches']
    assert counts['attention'] == [2 * (STEPS * ACCUM + 1)]
    # the CPU takes no kernel
    assert counts['batch_norm'] == [0] and counts['group_norm'] == [0]


def test_model_spans_nest_under_the_step(run):
    _, _, recorded = run
    by_id = {s.id: s for s in recorded}
    names = (profiling.MODEL_CNN, profiling.MODEL_TRANSFORMER,
             profiling.MODEL_DECODER)
    for name in names:
        mine = [s for s in recorded if s.name == name]
        under = [s for s in mine if s.parent is not None
                 and by_id[s.parent].name == profiling.TRAIN_STEP]
        # one a microbatch inside the steps; validation's forward has no
        # step around it
        assert len(under) == STEPS * ACCUM, name
        for s in under:
            step = by_id[s.parent]
            assert step.start_ns <= s.start_ns <= s.end_ns <= step.end_ns
    first = sorted((s for s in recorded if s.name in names),
                   key=lambda s: s.start_ns)[:3]
    assert [s.name for s in first] == list(names)


def test_spans_off_record_nothing(tmp_path):
    prog, _ = _pair()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            prog(_x())
    assert not [e for e in prof.events() if e.name.startswith('model.')]
    spans.start()
    assert spans.stop() == []


def test_predict_cli_runs_the_trained_weights_and_refuses_bands(run):
    from PIL import Image
    from unet_tpu_torch.cli.predict import main as predict, parse_args
    from unet_tpu_torch.cli.predict import run_directory
    tmp, result, _ = run
    weights = Path(result['save_dir']) / 'weights' / 'last'
    src = tmp / 'src'
    src.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        Image.fromarray((rng.random((64, 64)) * 255).astype(np.uint8)).save(
            src / f's{i}.png')
    out = tmp / 'pred'
    argv = ['--weights', str(weights), '--source', str(src), '--output',
            str(out), '--img-size', '64', '--batch-size', '2', '--device',
            'cpu']
    summary = predict(argv)
    assert summary['processed'] == 3
    assert sorted(p.name for p in out.iterdir()) == [
        f's{i}_mask.png' for i in range(3)]
    args = parse_args(argv + ['--spatial-shard'])
    with pytest.raises(ValueError, match='height bands'):
        run_directory(args, [torch.device('cpu')] * 2)
    argv[argv.index('--img-size') + 1] = '128'
    with pytest.raises(ValueError, match='--img-size 64'):
        predict(argv)


@pytest.mark.chip
def test_bf16_attention_on_the_card_is_fused_and_matches_math():
    """At the published shape (b4, 12 heads, 1024 tokens of 64): the entry
    point runs with the math backend excluded, and matches the math
    backend on the same bf16 inputs (fp32 accumulation in both; the
    fused kernels round P to bf16 before P V) within 2e-2 of the largest
    output, forward and gradients."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from torch.nn.attention import SDPBackend, sdpa_kernel
    g = torch.Generator(device='cuda').manual_seed(0)
    q, k, v = (torch.randn(4, 12, 1024, 64, device='cuda', generator=g)
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    dout = torch.randn(4, 12, 1024, 64, device='cuda', generator=g).to(
        torch.bfloat16)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = attn_ops.attention(q, k, v)
        out.backward(dout)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type.name == 'CUDA']
    assert any('sdpa' in n or 'flash' in n or 'fmha' in n for n in names)
    got = [out.detach()] + [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    with sdpa_kernel([SDPBackend.MATH]):
        out = torch.nn.functional.scaled_dot_product_attention(q, k, v)
        out.backward(dout)
    want = [out.detach()] + [t.grad for t in (q, k, v)]
    for a, b in zip(got, want):
        err = float((a.float() - b.float()).abs().max())
        assert err <= 2e-2 * float(b.float().abs().max()), err
