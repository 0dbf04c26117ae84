"""Data-parallel layout of ranks over devices.

Counterpart of ``unet_tpu/core/mesh.py`` in torch's idiom: where JAX
builds one device mesh that GSPMD shards batches over, here each device
is driven by its own process (a rank). ``tpu.data_parallel`` sets how
many ranks a host runs (-1: one per local device); rank
``process_id * local_degree + local_index`` drives ``cuda:local_index``
(or the CPU). Parameters and buffers start replicated from rank 0, and
the global batch is split evenly over the ranks.
"""

from __future__ import annotations

import socket
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn as nn


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

