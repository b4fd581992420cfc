"""Model factory of the PyTorch port (the JAX package's `get_model`, with
the flagship `enhanced_unet` registered).

Every model is called as `model(x_nhwc) -> (logits_nhwc_f32, aux_dict)`.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn as nn

from enhanced_unet_tpu_torch.device import resolve_device
from enhanced_unet_tpu_torch.models.enhanced_unet import (
    DeepLabV3Plus,
    EnhancedUNet,
    UNetPlusPlus,
)

_REGISTRY = {
    "enhanced_unet": EnhancedUNet,
}


def init_random_weights_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random weights from an explicit generator: conv kernels
    N(0, 1/fan_in), conv biases N(0, 0.05^2), and BatchNorm affine params and
    running statistics that are not the identity.  In place; returns
    `model`."""
    gen = torch.Generator().manual_seed(seed)

    def randn(shape):
        return torch.randn(shape, generator=gen)

    def rand(shape):
        return torch.rand(shape, generator=gen)

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(randn(m.weight.shape) / fan_in ** 0.5)
                if m.bias is not None:
                    m.bias.copy_(randn(m.bias.shape) * 0.05)
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.copy_(rand(m.weight.shape) * 0.5 + 0.75)
                m.bias.copy_(randn(m.bias.shape) * 0.1)
                m.running_mean.copy_(randn(m.running_mean.shape) * 0.1)
                m.running_var.copy_(rand(m.running_var.shape) * 0.5 + 0.75)
    return model


def get_model(model_name: str, num_classes: int = 3,
              dtype: torch.dtype = torch.bfloat16,
              device: Optional[Union[str, torch.device]] = None,
              seed: int = 0, **kwargs) -> nn.Module:
    """Build `model_name` with seeded random weights, in eval mode, on
    `device` (None: the CUDA card, raising if there is none)."""
    if model_name not in _REGISTRY:
        raise ValueError(
            f"Unknown model: {model_name}; expected one of {sorted(_REGISTRY)}")
    device = resolve_device(device)
    model = _REGISTRY[model_name](num_classes=num_classes, dtype=dtype, **kwargs)
    init_random_weights_(model, seed)
    model = model.to(device).eval()
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model


__all__ = ["get_model", "init_random_weights_", "EnhancedUNet",
           "UNetPlusPlus", "DeepLabV3Plus"]
