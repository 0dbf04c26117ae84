"""Data-parallel layout of ranks and inference replicas over devices.

Counterpart of ``unet_tpu/core/mesh.py`` in torch's idiom: where JAX
builds one device mesh that GSPMD shards batches over, here training
drives each device from its own process (a rank). ``tpu.data_parallel``
sets how many ranks a host runs (-1: one per local device); rank
``process_id * local_degree + local_index`` drives ``cuda:local_index``
(or the CPU). Parameters and buffers start replicated from rank 0, and
the global batch is split evenly over the ranks.

Inference (serve and predict) stays in one process, as JAX's does over
its local devices (``batch_sharding`` and ``replicate``): a
``ReplicaSet`` holds an eval copy of the model on each device and splits
every batch's rows into equal contiguous blocks, one per replica.
"""

from __future__ import annotations

import copy
import socket
from typing import Callable, List, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from unet_tpu_torch import resolve_device


def local_degree(data_parallel: Optional[int], device) -> int:
    """Ranks this host runs: ``data_parallel``, where -1 (or None) means
    every local device (the CUDA devices; one for the CPU)."""
    device = torch.device(device)
    n_dev = torch.cuda.device_count() if device.type == 'cuda' else 1
    if data_parallel in (-1, None):
        return max(n_dev, 1)
    if data_parallel < 1:
        raise ValueError(f'tpu.data_parallel {data_parallel} must be -1 or '
                         '>= 1')
    if device.type == 'cuda' and data_parallel > n_dev:
        raise ValueError(f'tpu.data_parallel {data_parallel} exceeds the '
                         f'{n_dev} local CUDA devices')
    return data_parallel


def global_rank(process_id: int, degree: int, local_index: int) -> int:
    return process_id * degree + local_index


def rank_device(device, local_index: int) -> torch.device:
    """The device of local rank ``local_index``."""
    device = torch.device(device)
    if device.type == 'cuda':
        return torch.device('cuda', local_index)
    return device


def check_global_batch(batch_size: int, world_size: int) -> None:
    if batch_size % world_size != 0:
        raise ValueError(f'batch_size {batch_size} must be divisible by '
                         f'the data-parallel degree {world_size}')


@torch.no_grad()
def replicate(module: nn.Module) -> nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0, in
    place (a no-op outside a process group)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)
    return module


def free_port() -> int:
    """A free TCP port on localhost for a rendezvous."""
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]



# ---------------------------------------------------------------- inference

def inference_devices(device=None) -> List[torch.device]:
    """The devices inference splits its batches over: every visible CUDA
    device for ``cuda`` (the default), the one device a name with an
    index gives (``cuda:1``, ``cpu``), or ``device`` itself where it is a
    list. A list may repeat a device (``['cuda:0', 'cuda:0']``: two
    replicas on one card). Raises where CUDA is named and absent."""
    if isinstance(device, (list, tuple)):
        return [resolve_device(d) for d in device]
    dev = resolve_device(device)
    if dev.type == 'cuda' and dev.index is None:
        return [torch.device('cuda', i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def _device_of(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


class PendingMasks:
    """The packed masks of one ``ReplicaSet.run``, in row order once
    ``wait`` returns."""

    def __init__(self, parts, events, dim: int):
        self._parts, self._events, self._dim = parts, events, dim

    def wait(self) -> torch.Tensor:
        """Block until every replica's copy is back; the masks on the
        host."""
        for ev in self._events:
            ev.synchronize()
        if len(self._parts) == 1:
            return self._parts[0]
        return torch.cat(self._parts, self._dim)


class ReplicaSet:
    """One eval copy of ``model`` per device of ``devices`` (the model
    itself where it already lies there; a device listed twice shares its
    copy), and one predict step per listed device, made by
    ``make_step(copy)``.

    ``run(u8, thresholds)`` splits the batch's rows into equal contiguous
    blocks, one per listed device in order. Each block is enqueued under
    its device's guard (the kernel wrappers take the current device's
    SM count and stream) on a stream of its own, and its packed masks are
    copied back to pinned host memory behind it, so the devices compute
    at once. ``per_row_thresholds`` says what the step takes: a (N,)
    threshold per row, split with the rows and giving (N, ...) masks (the
    serve step), or a (T,) sweep given to every block, giving (T, N, ...)
    masks (the predict step)."""

    def __init__(self, model: nn.Module, devices, make_step: Callable,
                 per_row_thresholds: bool):
        self.devices = [torch.device(d) for d in devices]
        self.per_row = per_row_thresholds
        copies = {_device_of(model): model}
        for d in self.devices:
            if d not in copies:
                copies[d] = copy.deepcopy(model).to(d).eval()
        # one step and one stream per listed device
        self.steps = [make_step(copies[d]) for d in self.devices]
        self._streams = [torch.cuda.Stream(device=d) if d.type == 'cuda'
                         else None for d in self.devices]
        for d in copies:  # the copies are written before a stream reads
            if d.type == 'cuda':
                torch.cuda.synchronize(d)

    def __len__(self) -> int:
        return len(self.devices)

    def run(self, u8: torch.Tensor, thresholds: torch.Tensor
            ) -> PendingMasks:
        """Enqueue the predict step on every replica; ``u8`` (N, 1, H, W)
        uint8 and ``thresholds`` float32 on the host (pinned ``u8``
        overlaps its copies)."""
        n, r = u8.shape[0], len(self.devices)
        if n % r:
            raise ValueError(f'{n} rows do not split over {r} replicas')
        block = n // r
        parts, events = [], []
        for i, (d, step, stream) in enumerate(zip(
                self.devices, self.steps, self._streams)):
            rows = slice(i * block, (i + 1) * block)
            thr = thresholds[rows] if self.per_row else thresholds
            if stream is None:
                parts.append(step(u8[rows].to(d), thr.to(d)))
                continue
            with torch.cuda.device(d), torch.cuda.stream(stream):
                out = step(u8[rows].to(d, non_blocking=True),
                           thr.to(d, non_blocking=True))
                host = torch.empty(out.shape, dtype=out.dtype,
                                   pin_memory=True)
                host.copy_(out, non_blocking=True)
                events.append(torch.cuda.Event())
                events[-1].record(stream)
            parts.append(host)
        return PendingMasks(parts, events, 0 if self.per_row else 1)
