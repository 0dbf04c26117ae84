"""Tensor ops of the port: resize, pool, bit-packing and the fused
attention gate (CUDA kernel plus its plain PyTorch version)."""
