"""The plain reference: the same networks, losses, augmentation and
optimizer step in plain PyTorch, float32 with TF32 off. It imports
nothing of the program and takes nothing the program made: it is handed
the benchmark's own weights and slices and works out the rest again."""

import torch


def strict_fp32() -> None:
    """float32 convolutions and matrix products without TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
