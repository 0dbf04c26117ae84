"""UNet / Attention U-Net (PyTorch)."""

from unet_tpu_torch.models.unet import (MODEL_REGISTRY, AttentionUNet, UNet,
                                        create_model, init_parameters)

__all__ = ['MODEL_REGISTRY', 'AttentionUNet', 'UNet', 'create_model',
           'init_parameters']
