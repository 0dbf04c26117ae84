"""2x2/stride-2 max pooling (counterpart of ``unet_tpu/ops/pool.py``).

The JAX package's elementwise-backward variant (``max_pool_2x2``) is a
TPU lowering; ATen's pool already routes the gradient to the first
maximal element of each window, so only ``max_pool`` is ported.
"""

import torch
import torch.nn.functional as F


def max_pool(x: torch.Tensor) -> torch.Tensor:
    """2x2 window, stride 2, no padding (odd trailing rows/cols dropped)
    on an (N, C, H, W) tensor."""
    return F.max_pool2d(x, kernel_size=2, stride=2)
