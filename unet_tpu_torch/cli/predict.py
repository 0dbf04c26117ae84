"""Model loading and pre/postprocessing for inference.

Counterpart of ``load_model``, ``preprocess_image`` and
``postprocess_mask`` in ``unet_tpu/cli/predict.py``; the directory
predict CLI itself joins in a later slice. The model is rebuilt from the
config embedded in a reference-format ``.pt`` checkpoint.
"""

from __future__ import annotations

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


def postprocess_mask(prob_tumor, threshold, orig_size):
    """prob > threshold -> uint8 {0,255} -> NEAREST resize to the
    original (W, H)."""
    from PIL import Image
    mask = (np.asarray(prob_tumor) > threshold).astype(np.uint8) * 255
    m = Image.fromarray(mask)
    if m.size != orig_size:
        m = m.resize(orig_size, Image.NEAREST)
    return np.asarray(m)
