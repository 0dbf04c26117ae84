"""Multi-process support over ``torch.distributed``.

Counterpart of ``unet_tpu/core/distributed.py``. JAX runs one process
per host that drives every local chip; here one process drives one
device, so a "process" below is a rank of the process group and
``process_count`` is the world size. Every rank loads only its rows of
each global batch (``data.dataset.BatchLoader``'s ``local_slice``);
gradients, BatchNorm statistics and validation counts are summed over
the ranks by collectives.

The backend is ``nccl`` for CUDA ranks and ``gloo`` for CPU ranks.
``UNET_TORCH_DIST_BACKEND=gloo`` forces gloo for CUDA ranks, which two
ranks sharing one card need (NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence, TypeVar

import torch
import torch.distributed as dist

T = TypeVar('T')

BACKEND_ENV = 'UNET_TORCH_DIST_BACKEND'
_BACKENDS = ('gloo', 'nccl')


def backend_for(device) -> str:
    """The process-group backend for ranks on ``device``."""
    forced = os.environ.get(BACKEND_ENV, '').strip().lower()
    if forced:
        if forced not in _BACKENDS:
            raise ValueError(f'{BACKEND_ENV}={forced!r}: use one of '
                             f'{_BACKENDS}')
        return forced
    return 'nccl' if torch.device(device).type == 'cuda' else 'gloo'


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device='cpu',
                     timeout_seconds: float = 1800) -> None:
    """Join the process group of ``num_processes`` ranks as rank
    ``process_id``, meeting at ``coordinator_address`` (``host:port``,
    served by rank 0). A no-op for one process or when the group exists.

    A run that asked for more than one process raises when it cannot
    join within ``timeout_seconds`` (which also bounds each collective);
    it never carries on as a single process, where each process would
    train on the full data and write over the others' run directory."""
    if not num_processes or num_processes <= 1 or dist.is_initialized():
        return
    if not coordinator_address or process_id is None:
        raise ValueError(f'{num_processes} processes need a coordinator '
                         'address and a process id')
    if not 0 <= process_id < num_processes:
        raise ValueError(f'process id {process_id} is outside '
                         f'[0, {num_processes})')
    dist.init_process_group(
        backend_for(device), init_method=f'tcp://{coordinator_address}',
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_seconds))


def is_distributed() -> bool:
    """True inside a process group of more than one rank."""
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def broadcast_from_main(obj=None):
    """Rank 0's ``obj`` on every rank (any picklable object).

    Used for decisions every rank must share, such as ``--resume auto``:
    checkpoints live on rank 0's filesystem, and ranks that resolved it
    against their own disks would start at other epochs and then wait
    forever in mismatched collectives."""
    if not is_distributed():
        return obj
    box = [obj if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def gather_objects(obj) -> list:
    """Every rank's ``obj`` (picklable), in rank order, on every rank."""
    if not is_distributed():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def all_reduce_sum_(tensor: torch.Tensor) -> torch.Tensor:
    """Sum ``tensor`` over the ranks, in place; unchanged for one rank."""
    if is_distributed():
        dist.all_reduce(tensor)
    return tensor


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose gradient is the sum over the ranks of the
    incoming gradients: every rank's loss depends on every rank's input
    through the sum."""

    @staticmethod
    def forward(ctx, tensor):
        out = tensor.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(tensor: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of ``tensor`` over the ranks (a new tensor)."""
    return _AllReduceSum.apply(tensor)


def barrier() -> None:
    if is_distributed():
        dist.barrier()


def shard_for_process(items: Sequence[T], index: Optional[int] = None,
                      count: Optional[int] = None) -> List[T]:
    """Deterministic strided shard of a (file) list for this rank. Every
    rank must pass the same ordering; striding spreads each volume's
    slices over the ranks."""
    if index is None:
        index = process_index()
    if count is None:
        count = process_count()
    return list(items[index::count])
