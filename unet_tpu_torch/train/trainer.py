"""Predict-step factories (counterpart of the predict half of
``unet_tpu/train/trainer.py``; the train step joins with the training
slice).

Each factory closes over an eval-mode model and returns a function of
tensors on the model's device that runs under ``torch.inference_mode``.
Inputs are NCHW: float images (N, C, H, W) or raw uint8 slices
(N, 1, H, W), normalized on the device as ``(x/255 - 0.5)/0.5``.
"""

from __future__ import annotations

from typing import Callable

import torch

from unet_tpu_torch.ops.bitpack import pack_masks_device


def make_predict_step(model) -> Callable:
    """step(images) -> float32 softmax probabilities (N, n_classes, H, W)."""

    @torch.inference_mode()
    def predict_step(images: torch.Tensor) -> torch.Tensor:
        return torch.softmax(model(images).float(), dim=1)

    return predict_step


def make_predict_step_u8(model) -> Callable:
    """``make_predict_step`` on (N, 1, H, W) uint8, normalized on the
    device; the host->device wire ships raw bytes (4x less than f32)."""
    base = make_predict_step(model)

    @torch.inference_mode()
    def predict_step(u8: torch.Tensor) -> torch.Tensor:
        x = u8.float() / 255.0
        return base((x - 0.5) / 0.5)

    return predict_step


def make_predict_masks_step(model) -> Callable:
    """step(u8, thresholds) with a (T,) float32 threshold vector ->
    (T, N, H, ceil(W/8)) uint8: for each threshold t the bit-packed mask
    of ``softmax(logits)[:, 1] > t``. Only 1 bit per pixel is read back
    (unpack with ``ops.bitpack.unpack_masks_host``)."""
    base = make_predict_step_u8(model)

    @torch.inference_mode()
    def step(u8: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
        tumor = base(u8)[:, 1]                              # (N, H, W) f32
        return pack_masks_device(tumor[None] > thresholds[:, None, None, None])

    return step


def make_serve_masks_step(model) -> Callable:
    """Per-row-threshold variant for the serving tier: step(u8,
    thresholds) with a (N,) threshold vector (each micro-batched request
    carries its own) -> (N, H, ceil(W/8)) packed masks."""
    base = make_predict_step_u8(model)

    @torch.inference_mode()
    def step(u8: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
        tumor = base(u8)[:, 1]                              # (N, H, W) f32
        return pack_masks_device(tumor > thresholds[:, None, None])

    return step
