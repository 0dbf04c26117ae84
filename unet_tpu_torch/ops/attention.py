"""Multi-head scaled dot-product attention for the port's transformer
blocks (``models/transunet.py``).

Replaces no TPU kernel: the JAX package has no transformer. The entry
point is ``F.scaled_dot_product_attention`` restricted to its fused
backends on CUDA (flash, memory-efficient, cuDNN), so that a shape or
dtype none of them takes raises instead of falling back, silently and
slowly, to the math backend, which writes the N x N scores and
probabilities to device memory. On the CPU it runs the math backend:
softmax(q k^T / sqrt(d)) v written out.

Its calls, forward only, count under ``'attention'`` in the kernels'
tally, ``_build.launches`` (the train CLI logs it over a run).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from unet_tpu_torch.ops._build import launches


def _backends(device: torch.device):
    from torch.nn.attention import SDPBackend
    if device.type == 'cuda':
        return [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                SDPBackend.CUDNN_ATTENTION]
    return [SDPBackend.MATH]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              dropout_p: float = 0.0) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v of (B, heads, N, d) tensors, with
    dropout ``dropout_p`` on the probabilities (from torch's own
    generator). Differentiable; on CUDA only through a fused backend."""
    from torch.nn.attention import sdpa_kernel
    with sdpa_kernel(_backends(q.device)):
        out = F.scaled_dot_product_attention(q, k, v, dropout_p=dropout_p)
    launches['attention'] += 1
    return out
