"""PSPNet, ported from `enhanced_unet_tpu/models/pspnet.py`: pyramid scene
parsing over ResNet-34 (encoder depth 4) and the reference's BasicPSPNet
fallback.

- BasicPSPNet: three single 3x3 ConvBNAct stages (`enc1`..`enc3`) with two
  2x2 pools, the raw pyramid {1, 2, 4} (adaptive average pools resized
  back) concatenated after the s4 feature, a 3x3 ConvBNAct (`fuse`), a 1x1
  head (`head`) and two bilinear 2x upsamples.
- PSPNet: `model.encoder` (torchvision ResNet-34), `model.psp` (PSPModule,
  bins 1, 2, 3, 6, a quarter of the channels each), `model.bottleneck` (1x1
  ConvBNAct to 512), dropout 0.1 in train mode, `model.segmentation_head.0`
  (3x3 with a bias), the logits resized to the input.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from enhanced_unet_tpu_torch.models.blocks import (
    ConvBNAct,
    NHWCModel,
    PSPModule,
    _adaptive_avg_pool,
    conv,
    dropout,
    max_pool_2x2,
    row_split,
)
from enhanced_unet_tpu_torch.models.encoders import ResNetEncoder
from enhanced_unet_tpu_torch.ops.resize import resize_bilinear_nchw, upsample2x_nchw


class BasicPSPNet(NHWCModel):
    BINS = (1, 2, 4)

    def __init__(self, num_classes: int = 3, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.enc1 = ConvBNAct(3, 64, dtype=dtype)
        self.enc2 = ConvBNAct(64, 128, dtype=dtype)
        row_split(self.enc2[0])
        self.enc3 = ConvBNAct(128, 256, dtype=dtype)
        self.fuse = ConvBNAct(256 * (1 + len(self.BINS)), 128, dtype=dtype)
        self.head = nn.Conv2d(128, num_classes, 1)
        self.dtype = dtype

    def logits(self, x, generator: Optional[torch.Generator] = None):
        e3 = self.enc3(max_pool_2x2(self.enc2(max_pool_2x2(self.enc1(x)))))
        size = e3.shape[2:]
        pyramid = [e3] + [resize_bilinear_nchw(_adaptive_avg_pool(e3, b), size).to(e3.dtype)
                          for b in self.BINS]
        d = conv(self.fuse(torch.cat(pyramid, dim=1)), self.head, self.dtype)
        return upsample2x_nchw(upsample2x_nchw(d.float()))


class PSPNet(NHWCModel):
    """resnet34-backed PSPNet (encoder depth 4)."""

    def __init__(self, num_classes: int = 3, encoder_name: str = "resnet34",
                 dropout: float = 0.1, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        encoder = ResNetEncoder(encoder_name, 4, dtype)
        c = encoder.out_channels[-1]
        self.model = nn.ModuleDict({
            "encoder": encoder,
            "psp": PSPModule(c, c // 4, dtype=dtype),
            "bottleneck": ConvBNAct(c + 4 * (c // 4), 512, 1, dtype=dtype),
            "segmentation_head": nn.Sequential(nn.Conv2d(512, num_classes, 3, padding=1)),
        })
        self.dropout = dropout
        self.dtype = dtype

    def logits(self, x, generator: Optional[torch.Generator] = None):
        m = self.model
        y = m["bottleneck"](m["psp"](m["encoder"](x)[-1]))
        if self.training:
            y = dropout(y, self.dropout, generator)
        logits = conv(y, m["segmentation_head"][0], self.dtype).float()
        return resize_bilinear_nchw(logits, x.shape[2:])
