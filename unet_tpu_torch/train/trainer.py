"""Train, eval and predict steps.

Counterpart of ``unet_tpu/train/trainer.py``:

* ``make_train_step`` runs one optimizer step over a super-batch of
  ``accum_steps`` microbatches shaped (A, B, C, H, W): forward and
  backward per real microbatch (grads summed), then the global-norm
  clip, AdamW and the EMA update. It returns the summed loss as a device
  scalar, so the host never waits on a step.
* A per-microbatch mask reproduces the leftover flush: padded
  microbatches (mask 0) are skipped entirely (no forward, so BatchNorm's
  running statistics move on real microbatches only), and the grad sum
  is still divided by ``accum_steps``.
* Inside a process group of several ranks (data parallel), each rank
  runs its rows of every microbatch, and the step makes exactly one
  gradient reduction: after the real microbatches are summed, one flat
  all-reduce averages the grads (and the loss) over the ranks, which
  gives the global batch's mean gradient; the clip, AdamW and the EMA
  then run on identical values on every rank. A loss normalized by a
  sum over the batch's rows (class-weighted CE, or any loss with sample
  weights) is given ``den_reduce=rank_mean``, so that the ranks' mean of
  their losses is the global batch's loss (``train.losses``).
* ``make_eval_step`` returns (loss, confusion matrix) on the device.
* The EMA shadow blends parameters and copies BatchNorm buffers.
* The predict steps normalize uint8 input on the device and threshold
  and bit-pack masks there.

Parameters, grads and optimizer state are float32; the model computes
in its ``dtype``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from unet_tpu_torch.core.distributed import (all_reduce_sum,
                                             all_reduce_sum_,
                                             is_distributed, process_count)
from unet_tpu_torch.ops.bitpack import pack_masks_device
from unet_tpu_torch.train.metrics import confusion_matrix_update
from unet_tpu_torch.utils.profiling import STEP_UPDATE, annotate


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


# ---------------------------------------------------------------- training

def create_optimizer(model: nn.Module, lr: float,
                     weight_decay: float = 1e-4) -> torch.optim.AdamW:
    """AdamW (0.9, 0.999, eps 1e-8) with weight decay on every parameter,
    BatchNorm scale and bias included, as the JAX package's optax chain.
    The global-norm clip is ``clip_by_global_norm``, applied by the train
    step before ``step()``; the train loop sets the learning rate each
    epoch."""
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float) -> torch.Tensor:
    """optax's rule, in place: where the global L2 norm of ``grads`` is
    not below ``max_norm``, each grad becomes ``(g / norm) * max_norm``
    (``clip_grad_norm_`` would divide by ``norm + 1e-6`` instead). Stays
    on the device; returns the norm."""
    grads = list(grads)
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads]))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


@dataclasses.dataclass
class EmaState:
    """EMA shadow of a model: float32 parameter copies, BatchNorm buffer
    copies, and the number of updates."""
    params: Dict[str, torch.Tensor]
    buffers: Dict[str, torch.Tensor]
    updates: int = 0

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The shadow as a model state dict (for ``load_state_dict``)."""
        return {**self.params, **self.buffers}


def ema_reinit(model: nn.Module) -> EmaState:
    """A fresh EMA from the live model (copies, not aliases), with its
    update counter at 0."""
    return EmaState(
        params={k: p.detach().clone() for k, p in model.named_parameters()},
        buffers={k: b.detach().clone() for k, b in model.named_buffers()})


@torch.no_grad()
def ema_update(ema: EmaState, model: nn.Module, decay: float,
               warmup_steps: int = 0) -> EmaState:
    """One EMA update in place: optional early ramp
    min(decay, (1+u)/(10+u)) for the first ``warmup_steps`` updates,
    params blended as ``d*e + (1-d)*p`` in float32, buffers copied."""
    ema.updates += 1
    u = ema.updates
    d = decay
    if warmup_steps > 0 and u <= warmup_steps:
        d = min(decay, (1.0 + u) / (10.0 + u))
    d32 = np.float32(d)
    one_minus = float(np.float32(1.0) - d32)
    for k, p in model.named_parameters():
        e = ema.params[k]
        e.copy_(e * float(d32) + p * one_minus)
    for k, b in model.named_buffers():
        ema.buffers[k].copy_(b)
    return ema


def rank_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the ranks, differentiable: a loss's
    ``den_reduce`` inside a process group."""
    return all_reduce_sum(t) / process_count()


def _loss_kwargs() -> Dict[str, Callable]:
    """The losses' ``den_reduce`` where this process holds a rank's rows
    of the batch."""
    return {'den_reduce': rank_mean} if is_distributed() else {}


class TrainStep:
    """One optimizer step over a super-batch; see ``make_train_step``.
    ``steps`` counts the optimizer steps taken."""

    def __init__(self, model: nn.Module, loss_fn: Callable,
                 opt: torch.optim.Optimizer, accum_steps: int,
                 grad_clip: float = 1.0, ema_decay: float = 0.99,
                 use_ema: bool = False):
        self.model, self.loss_fn, self.opt = model, loss_fn, opt
        self.accum_steps = accum_steps
        self.grad_clip = grad_clip
        self.ema_decay, self.use_ema = ema_decay, use_ema
        self.steps = 0

    def accumulate(self, images: torch.Tensor, masks: torch.Tensor,
                   mb_mask) -> torch.Tensor:
        """Forward and backward over the real microbatches: leaves in each
        ``p.grad`` the sum of their gradients and returns the sum of their
        losses, both averaged over the ranks inside a process group."""
        model = self.model
        model.train()
        self.opt.zero_grad(set_to_none=True)
        loss_sum = torch.zeros((), device=images.device)
        kw = _loss_kwargs()
        for a in range(images.shape[0]):
            if not mb_mask[a]:
                continue  # padded microbatch: no forward, BN stats untouched
            loss = self.loss_fn(model(images[a]), masks[a], **kw)
            loss.backward()
            loss_sum = loss_sum + loss.detach()
        with torch.no_grad():
            grads = []
            for p in model.parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                grads.append(p.grad)
            if is_distributed():
                loss_sum = average_over_ranks(grads, loss_sum)
        return loss_sum

    def __call__(self, images: torch.Tensor, masks: torch.Tensor,
                 lr: float, mb_mask, ema: Optional[EmaState] = None
                 ) -> torch.Tensor:
        """images (A, B, C, H, W) float, masks (A, B, H, W) integer on the
        model's device (a rank's rows of each microbatch inside a process
        group); ``mb_mask`` (A,) host values in {0, 1} marking the real
        microbatches. Updates the model, the optimizer and ``ema`` in
        place; returns the sum of the real microbatches' losses as a
        device scalar."""
        model, params = self.model, [p for p in self.model.parameters()]
        loss_sum = self.accumulate(images, masks, mb_mask)
        with annotate(STEP_UPDATE, images.device):
            with torch.no_grad():
                for p in params:
                    p.grad.div_(self.accum_steps)
                if self.grad_clip and self.grad_clip > 0:
                    clip_by_global_norm([p.grad for p in params],
                                        self.grad_clip)
            for group in self.opt.param_groups:
                group['lr'] = lr
            self.opt.step()
            self.steps += 1
            if self.use_ema and ema is not None:
                ema_update(ema, model, self.ema_decay)
        return loss_sum


@torch.no_grad()
def average_over_ranks(grads, loss: torch.Tensor) -> torch.Tensor:
    """Average ``grads`` (in place) and ``loss`` over the ranks with one
    flat all-reduce; returns the averaged loss."""
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [loss.reshape(1).to(grads[0].dtype)])
    dist.all_reduce(flat)
    flat.div_(dist.get_world_size())
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return flat[offset].to(loss.dtype)


def make_train_step(model: nn.Module, loss_fn: Callable,
                    opt: torch.optim.Optimizer, accum_steps: int,
                    ema_decay: float = 0.99, use_ema: bool = False,
                    grad_clip: float = 1.0) -> TrainStep:
    """The super-batch train step:
    ``step(images, masks, lr, mb_mask, ema=None) -> loss_sum``. Sums the
    grads of the real microbatches, divides by ``accum_steps`` (not by
    the count of real ones, as the reference's leftover flush does),
    clips to ``grad_clip`` by global norm (0 disables), runs AdamW at
    ``lr`` and, with ``use_ema``, updates ``ema``."""
    return TrainStep(model, loss_fn, opt, accum_steps, grad_clip=grad_clip,
                     ema_decay=ema_decay, use_ema=use_ema)


def make_eval_step(model: nn.Module, loss_fn: Callable, num_classes: int,
                   with_weights: bool = False) -> Callable:
    """``eval_step(images, masks) -> (loss, confusion_matrix)`` in eval
    mode, both on the device. ``with_weights=True`` adds a per-sample
    weight vector: weight-0 rows (padding) count in neither the loss nor
    the confusion matrix."""

    @torch.inference_mode()
    def eval_step(images: torch.Tensor, masks: torch.Tensor):
        model.eval()
        logits = model(images)
        return (loss_fn(logits, masks, **_loss_kwargs()),
                confusion_matrix_update(logits, masks, num_classes))

    @torch.inference_mode()
    def eval_step_weighted(images: torch.Tensor, masks: torch.Tensor,
                           weights: torch.Tensor):
        model.eval()
        logits = model(images)
        loss = loss_fn(logits, masks, sample_weights=weights,
                       **_loss_kwargs())
        # weight-0 rows -> target -1, which confusion_matrix_update drops
        gated = torch.where(weights[:, None, None] > 0, masks.long(),
                            torch.full_like(masks, -1, dtype=torch.long))
        return loss, confusion_matrix_update(logits, gated, num_classes)

    return eval_step_weighted if with_weights else eval_step


def validation_loss(losses) -> float:
    """The validation loss from each batch's eval loss on this rank: the
    mean over the batches of each batch's loss over the global batch.
    Inside a process group the ranks' mean of their losses of a batch is
    that batch's loss (``make_eval_step`` passes ``den_reduce``), so one
    all-reduce and a division by the world size give every batch's
    global loss, as JAX's eval step on the sharded batch computes it."""
    if not losses:
        return 0.0
    per_batch = all_reduce_sum_(torch.stack(losses).float())
    return float(per_batch.mean()) / process_count()


def group_into_superbatches(n_batches: int, accum_steps: int
                            ) -> Iterator[Tuple[int, int]]:
    """(start, count) groups covering n_batches in chunks of
    accum_steps; the last may be shorter (the leftover flush)."""
    for start in range(0, n_batches, accum_steps):
        yield start, min(accum_steps, n_batches - start)
