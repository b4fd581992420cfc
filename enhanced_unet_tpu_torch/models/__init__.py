"""Model factory of the PyTorch port: the JAX package's `get_model` with
its eleven names (the reference's six slots and the `*_basic` fallbacks).

Every model is called as `model(x_nhwc, generator=None) ->
(logits_nhwc_f32, aux_dict)`; only `enhanced_unet` has aux outputs.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn as nn

from enhanced_unet_tpu_torch.device import resolve_device
from enhanced_unet_tpu_torch.models.enhanced_unet import (
    DeepLabV3Plus,
    EnhancedUNet,
    EnhancedUNetBasic,
    UNetPlusPlus,
)
from enhanced_unet_tpu_torch.models.fcn import FCN, BasicFCN
from enhanced_unet_tpu_torch.models.linknet import BasicLinkNet, LinkNet
from enhanced_unet_tpu_torch.models.pspnet import BasicPSPNet, PSPNet
from enhanced_unet_tpu_torch.models.segnet import SegNet
from enhanced_unet_tpu_torch.models.unet import BasicUNet, UNet

_REGISTRY = {
    "segnet": SegNet,
    "unet": UNet,
    "unet_basic": BasicUNet,
    "enhanced_unet": EnhancedUNet,
    "enhanced_unet_basic": EnhancedUNetBasic,
    "fcn": FCN,
    "fcn_basic": BasicFCN,
    "pspnet": PSPNet,
    "pspnet_basic": BasicPSPNet,
    "linknet": LinkNet,
    "linknet_basic": BasicLinkNet,
}


def init_random_weights_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random weights from an explicit generator: conv and
    transposed-conv kernels N(0, 1/fan_in) (fan_in: the input channels of a
    group times the taps), their biases N(0, 0.05^2), and BatchNorm affine
    params and running statistics that are not the identity.  In place;
    returns `model`."""
    gen = torch.Generator().manual_seed(seed)

    def randn(shape):
        return torch.randn(shape, generator=gen)

    def rand(shape):
        return torch.rand(shape, generator=gen)

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                fan_in = m.in_channels // m.groups * m.kernel_size[0] * m.kernel_size[1]
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


__all__ = ["get_model", "init_random_weights_", "SegNet", "UNet", "BasicUNet",
           "EnhancedUNet", "EnhancedUNetBasic", "UNetPlusPlus", "DeepLabV3Plus",
           "FCN", "BasicFCN", "PSPNet", "BasicPSPNet", "LinkNet", "BasicLinkNet"]
