"""UNet family, ported from `enhanced_unet_tpu/models/unet.py`: BasicUNet
(the reference's hand-rolled fallback) and the ResNet-50 UNet (smp.Unet).

- BasicUNet: four DoubleConv stages (`enc1`..`enc4`, each `0`, `1`
  ConvBNActs) with 2x2 max pools between, a bilinear up-concat decoder
  (`dec4`..`dec2`) and a 1x1 head (`head`), the names of the reference
  fallback.
- UNet: `model.encoder` (torchvision ResNet-50, the reference's wrapper
  layout), `model.decoder.blocks.{0..4}` (smp's nearest up-concat decoder,
  channels 256-128-64-32-16) and `model.segmentation_head.0`, a plain 3x3
  conv with a bias.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn

from enhanced_unet_tpu_torch.models.blocks import (
    ConvBNAct,
    NHWCModel,
    UpConcatBlock,
    conv,
    max_pool_2x2,
    row_split,
)
from enhanced_unet_tpu_torch.models.encoders import ResNetEncoder


def double_conv(cin: int, cout: int, dtype: torch.dtype) -> nn.Sequential:
    second = ConvBNAct(cout, cout, dtype=dtype)
    row_split(second[0])
    return nn.Sequential(ConvBNAct(cin, cout, dtype=dtype), second)


class BasicUNet(NHWCModel):
    """The reference's fallback UNet: the 1x1 head on the last decoder
    stage, which is at full resolution."""

    def __init__(self, num_classes: int = 3, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        for i, (cin, cout) in enumerate(((3, 64), (64, 128), (128, 256), (256, 512)), 1):
            setattr(self, f"enc{i}", double_conv(cin, cout, dtype))
        self.dec4 = UpConcatBlock(512, 256, 256, bilinear=True, dtype=dtype)
        self.dec3 = UpConcatBlock(256, 128, 128, bilinear=True, dtype=dtype)
        self.dec2 = UpConcatBlock(128, 64, 64, bilinear=True, dtype=dtype)
        self.head = nn.Conv2d(64, num_classes, 1)
        self.dtype = dtype

    def logits(self, x, generator: Optional[torch.Generator] = None):
        e1 = self.enc1(x)
        e2 = self.enc2(max_pool_2x2(e1))
        e3 = self.enc3(max_pool_2x2(e2))
        e4 = self.enc4(max_pool_2x2(e3))
        d = self.dec2(self.dec3(self.dec4(e4, e3), e2), e1)
        return conv(d, self.head, self.dtype)


class UNetDecoder(nn.Module):
    """smp-style decoder: nearest up-concat blocks from the deepest feature,
    each taking the next shallower one as its skip (none for the last)."""

    def __init__(self, encoder_channels: Sequence[int],
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        skips = list(encoder_channels[1:-1])[::-1] + [0] * len(decoder_channels)
        cins = [encoder_channels[-1]] + list(decoder_channels[:-1])
        self.blocks = nn.ModuleList([
            UpConcatBlock(cin, skip, cout, dtype=dtype)
            for cin, skip, cout in zip(cins, skips, decoder_channels)])

    def forward(self, feats: List[torch.Tensor]) -> torch.Tensor:
        y = feats[-1]
        skips = feats[-2:0:-1]                  # [s16, s8, s4, s2]
        for i, block in enumerate(self.blocks):
            y = block(y, skips[i] if i < len(skips) else None)
        return y


class UNet(NHWCModel):
    """ResNet-backed UNet (smp.Unet, encoder depth 5)."""

    def __init__(self, num_classes: int = 3, encoder_name: str = "resnet50",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        encoder = ResNetEncoder(encoder_name, 5, dtype)
        self.model = nn.ModuleDict({
            "encoder": encoder,
            "decoder": UNetDecoder(encoder.out_channels, dtype=dtype),
            "segmentation_head": nn.Sequential(nn.Conv2d(16, num_classes, 3, padding=1)),
        })
        self.dtype = dtype

    def logits(self, x, generator: Optional[torch.Generator] = None):
        y = self.model["decoder"](self.model["encoder"](x))
        return conv(y, self.model["segmentation_head"][0], self.dtype)
