"""The port's networks (PyTorch) and the factory that builds them:
UNet and Attention U-Net (``unet.py``), TransUNet R50-ViT-B/16
(``transunet.py``)."""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn as nn

from unet_tpu_torch.models.transunet import (CONFIG_KEYS as _TRANSUNET_KEYS,
                                             Embeddings, TransUNet)
from unet_tpu_torch.models.unet import AttentionUNet, UNet

TRANSUNET = 'transunet_r50_vit_b16'

MODEL_REGISTRY = {
    'unet': UNet,
    'attention_unet': AttentionUNet,
    TRANSUNET: TransUNet,
}

__all__ = ['MODEL_REGISTRY', 'TRANSUNET', 'AttentionUNet', 'TransUNet',
           'UNet', 'create_model', 'create_model_from_config',
           'init_parameters']


def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Re-draw every parameter from ``generator``, module by module:
    torch's default init, U(+-1/sqrt(fan_in)) for weights and biases, for
    every conv (fan_in of a transposed conv counts its output channels,
    as torch does) and Linear layer; xavier-uniform weights and
    N(0, 1e-6) biases for the Linear layers marked ``xavier``
    (TransUNet's MLP, as published); LayerNorm and GroupNorm to ones and
    zeros; position embeddings to zeros. BatchNorm keeps its ones and
    zeros."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                w = m.weight
                bound = 1.0 / math.sqrt(w.shape[1] * w.shape[2] * w.shape[3])
                w.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, nn.Linear):
                fan_out, fan_in = m.weight.shape
                if getattr(m, 'xavier', False):
                    bound = math.sqrt(6.0 / (fan_in + fan_out))
                    m.weight.uniform_(-bound, bound, generator=generator)
                    m.bias.normal_(0.0, 1e-6, generator=generator)
                else:
                    bound = 1.0 / math.sqrt(fan_in)
                    m.weight.uniform_(-bound, bound, generator=generator)
                    m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, Embeddings):
                m.position_embeddings.zero_()


def create_model(model_type: str = 'attention_unet', *, n_channels: int = 1,
                 n_classes: int = 2, bilinear: bool = True,
                 base_features: int = 64, deep_supervision: bool = False,
                 dtype: torch.dtype = torch.float32,
                 use_fused_gate: Optional[bool] = None,
                 generator: Optional[torch.Generator] = None,
                 **transunet) -> nn.Module:
    """Model factory. Parameters are float32 on the CPU; with a
    ``generator`` they are drawn from it, else from torch's global RNG.
    ``transunet`` takes TransUNet's own keys (``transunet.CONFIG_KEYS``);
    the U-Nets' keys do not apply to it."""
    model_type = model_type.lower()
    if model_type not in MODEL_REGISTRY:
        raise ValueError(f'Unknown model type: {model_type}. '
                         f'Options: {sorted(MODEL_REGISTRY)}')
    if model_type == TRANSUNET:
        model = TransUNet(n_channels=n_channels, n_classes=n_classes,
                          dtype=dtype, **transunet)
    else:
        if transunet:
            raise TypeError(f'{model_type} takes no {sorted(transunet)}')
        kwargs = dict(n_channels=n_channels, n_classes=n_classes,
                      bilinear=bilinear, base_features=base_features,
                      dtype=dtype)
        if model_type == 'attention_unet':
            kwargs['deep_supervision'] = deep_supervision
            kwargs['use_fused_gate'] = use_fused_gate
        model = MODEL_REGISTRY[model_type](**kwargs)
    if generator is not None:
        init_parameters(model, generator)
    return model


def create_model_from_config(model_cfg: Dict, dtype: torch.dtype,
                             tpu_cfg: Optional[Dict] = None,
                             generator: Optional[torch.Generator] = None
                             ) -> nn.Module:
    """The network a config's ``model`` section describes (``type``
    ``attention`` is ``attention_unet``), computing in ``dtype``; the
    ``tpu`` section's ``fused_attention_gate`` routes an Attention
    U-Net's eval gates through the fused kernel. A TransUNet takes its
    keys from the section (``img_size`` among them: the train and predict
    CLIs fill it from ``data.img_size``), the published value for each
    one missing."""
    mtype = model_cfg.get('type', 'unet').lower()
    if mtype == 'attention':
        mtype = 'attention_unet'
    common = dict(n_channels=model_cfg.get('n_channels', 1),
                  n_classes=model_cfg.get('n_classes', 2), dtype=dtype,
                  generator=generator)
    if mtype == TRANSUNET:
        return create_model(mtype, **common, **{
            k: model_cfg[k] for k in _TRANSUNET_KEYS if k in model_cfg})
    return create_model(
        mtype, bilinear=model_cfg.get('bilinear', True),
        base_features=model_cfg.get('base_features', 64),
        deep_supervision=model_cfg.get('deep_supervision', False),
        use_fused_gate=(tpu_cfg or {}).get('fused_attention_gate'),
        **common)
