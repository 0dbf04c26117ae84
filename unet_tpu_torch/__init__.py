"""PyTorch/CUDA port of ``unet_tpu`` for NVIDIA Hopper (H100).

The JAX package ``unet_tpu`` stays the reference; this package is its
PyTorch counterpart and imports neither JAX nor anything of
``unet_tpu``. Module layout and names follow ``unet_tpu`` so each
counterpart is found at the same path. Tensors are NCHW in
``torch.channels_last`` memory (each pixel's channel vector contiguous,
which is what the hand-written kernels and cuDNN's bf16 convs want).

Where each part of ``unet_tpu`` lives here:

  unet_tpu/ops/resize.py           -> ops/resize.py (ATen interpolate/pad)
  unet_tpu/ops/pool.py::max_pool   -> ops/pool.py (F.max_pool2d)
  unet_tpu/ops/bitpack.py          -> ops/bitpack.py
  unet_tpu/ops/pallas/attention_gate.py
                                   -> ops/attention_gate.py + the CUDA
                                      kernel csrc/attention_gate.cu
  unet_tpu/ops/pallas/warp.py      -> ops/warp.py + the CUDA kernel
                                      csrc/warp.cu
  unet_tpu/ops/pallas/conv3x3.py   -> ops/conv3x3.py + the CUDA kernel
                                      csrc/conv3x3.cu (forward, data
                                      gradient, BN+ReLU epilogue; not
                                      wired into DoubleConv, as in
                                      unet_tpu; all three kernels built
                                      by ops/_build.py)
  unet_tpu/models/{layers,unet}.py -> models/{layers,unet}.py (train and
                                      eval mode; global-batch BatchNorm
                                      statistics over the ranks)
  unet_tpu/data/augmentations.py   -> data/augmentations.py (draws split
                                      from the deterministic apply)
  unet_tpu/data/dataset.py         -> data/dataset.py
  unet_tpu/data/cache.py           -> data/cache.py (build_cache, native
                                      or PIL, byte-identical blobs;
                                      CachedSliceDataset; native decode
                                      of request bodies and of files)
  unet_tpu/core/distributed.py     -> core/distributed.py (a
                                      torch.distributed process group,
                                      one process per rank; nccl for
                                      CUDA, gloo for CPU or when
                                      UNET_TORCH_DIST_BACKEND=gloo)
  unet_tpu/core/mesh.py            -> core/mesh.py (ranks over local
                                      devices, replicate from rank 0,
                                      local ranks spawned; no device
                                      mesh: each rank is a process)
  unet_tpu/train/losses.py         -> train/losses.py
  unet_tpu/train/metrics.py        -> train/metrics.py
  unet_tpu/train/schedules.py      -> train/schedules.py
  unet_tpu/train/trainer.py        -> train/trainer.py (AdamW with the
                                      optax clip rule, train/eval/predict
                                      steps, EMA)
  unet_tpu/train/callbacks.py      -> train/callbacks.py (reference .pt
                                      checkpoints, plus train_state.pt
                                      for --resume)
  unet_tpu/utils/config.py         -> utils/config.py
  unet_tpu/utils/torch_port.py     -> utils/torch_port.py
  unet_tpu/utils/plots.py          -> utils/plots.py (NCHW; matplotlib
                                      imported at first use)
  unet_tpu/utils/profiling.py      -> utils/profiling.py (torch.profiler
                                      traces; nan_guard checks losses)
  unet_tpu/cli/predict.py          -> cli/predict.py (the directory CLI,
                                      model loading, pre/postprocessing;
                                      one GPU)
  unet_tpu/cli/serve.py            -> cli/serve.py (one GPU)
  unet_tpu/cli/train.py            -> cli/train.py (--resume,
                                      --profile-dir, plots, --cache;
                                      data parallel over ranks:
                                      --coordinator, --num-processes,
                                      --process-id, tpu.data_parallel)
  unet_tpu/cli/overfit.py          -> cli/overfit.py

Still to port, in order: multi-GPU inference (the serve CLI's
data-parallel branch, predict's batch split and --spatial-shard); the
export CLI; the port's bench.

Not ported, because they are TPU lowerings of math ATen/cuDNN already
do: ops/s2d.py and IncPoolS2D (UNET_TPU_S2D, UNET_TPU_S2D_LEVEL),
ops/pool.py::max_pool_2x2 (UNET_TPU_ELEMENTWISE_POOL),
UNET_TPU_EVAL_CONCAT, UNET_TPU_MM_RESIZE, UNET_TPU_PSI_EINSUM, buffer
donation and the XLA compile cache (core/setup.py); and the warp's TPU
mechanics: warp_supported's H%8/W%128 gate, UNET_TPU_WARP_TILED_GATHER,
UNET_TPU_WARP_BAND2D and _warp_cp's custom_partitioning. There is no
counterpart of UNET_TPU_PALLAS_WARP: a CUDA tensor always takes the warp
kernel.
"""

import torch

__all__ = ['resolve_device']


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for (or implied) and absent; it
    never falls back to the CPU on its own."""
    dev = torch.device('cuda' if device in (None, '') else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device is available; pass '
                           "device='cpu' to run on the CPU")
    return dev
