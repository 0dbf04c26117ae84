"""Tensor ops of the port: resize, pool, bit-packing, the fused
attention gate and the fused augmentation warp (CUDA kernels plus their
plain PyTorch versions)."""
