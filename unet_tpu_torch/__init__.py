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
                                      (built by ops/_build.py)
  unet_tpu/models/{layers,unet}.py -> models/{layers,unet}.py (eval mode)
  unet_tpu/utils/torch_port.py     -> utils/torch_port.py
  unet_tpu/train/trainer.py        -> train/trainer.py (predict steps)
  unet_tpu/data/cache.py           -> data/cache.py (native decode only)
  unet_tpu/cli/predict.py          -> cli/predict.py (model loading and
                                      pre/postprocessing)
  unet_tpu/cli/serve.py            -> cli/serve.py (one GPU)

Still to port, in order: the train step with on-device augmentation and
its warp kernel (ops/pallas/warp.py), the 3x3 implicit-GEMM conv kernel
(ops/pallas/conv3x3.py), losses/metrics/schedules/callbacks, the data
pipeline, the train/predict/overfit/export CLIs, and multi-GPU
(core/mesh.py, core/distributed.py).

Not ported, because they are TPU lowerings of math ATen/cuDNN already
do: ops/s2d.py and IncPoolS2D (UNET_TPU_S2D, UNET_TPU_S2D_LEVEL),
ops/pool.py::max_pool_2x2 (UNET_TPU_ELEMENTWISE_POOL),
UNET_TPU_EVAL_CONCAT, UNET_TPU_MM_RESIZE, UNET_TPU_PSI_EINSUM, buffer
donation and the XLA compile cache (core/setup.py).
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
