"""The FCN slot, ported from `enhanced_unet_tpu/models/fcn.py`: FPN over
ResNet-18 (encoder depth 4) and the reference's BasicFCN fallback.

- BasicFCN: three stages of two 3x3 convs with a bias and no BN
  (`enc1`..`enc3`, ConvBNAct `use_bn=False`), two 2x2 pools, a light decoder
  (`dec3`, then a bilinear 2x up and `dec2`), a bilinear 2x up and a 1x1
  head (`head`).
- FCN: `model.encoder` (torchvision ResNet-18), `model.decoder` (FPNHead:
  1x1 `laterals.{i}` over the s2..s16 features, the top-down sum with
  bilinear resizes, two 3x3 ConvBNActs per level in `seg_blocks.{i}`, the
  levels resized to s2 and summed, dropout 0.2 in train mode) and
  `model.segmentation_head.0` (1x1), the logits resized to the input.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn

from enhanced_unet_tpu_torch.models.blocks import (
    ConvBNAct,
    NHWCModel,
    conv,
    dropout,
    max_pool_2x2,
    row_split,
)
from enhanced_unet_tpu_torch.models.encoders import ResNetEncoder
from enhanced_unet_tpu_torch.ops.resize import resize_bilinear_nchw, upsample2x_nchw


class BasicFCN(NHWCModel):
    def __init__(self, num_classes: int = 3, dtype: torch.dtype = torch.bfloat16):
        super().__init__()

        def cba(cin, cout):
            return ConvBNAct(cin, cout, use_bn=False, dtype=dtype)

        for i, (cin, cout) in enumerate(((3, 64), (64, 128), (128, 256)), 1):
            setattr(self, f"enc{i}", nn.Sequential(cba(cin, cout), cba(cout, cout)))
        row_split(self.enc1[1][0])
        self.dec3 = cba(256, 128)
        self.dec2 = cba(128, 64)
        self.head = nn.Conv2d(64, num_classes, 1)
        self.dtype = dtype

    def logits(self, x, generator: Optional[torch.Generator] = None):
        e1 = self.enc1(x)
        e2 = self.enc2(max_pool_2x2(e1))
        e3 = self.enc3(max_pool_2x2(e2))
        d2 = self.dec2(upsample2x_nchw(self.dec3(e3)))
        return conv(upsample2x_nchw(d2), self.head, self.dtype)


class FPNHead(nn.Module):
    """FPN decoder over features ordered fine to coarse."""

    def __init__(self, in_channels: Sequence[int], pyramid_channels: int = 256,
                 segmentation_channels: int = 128, dropout: float = 0.2,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.laterals = nn.ModuleList([nn.Conv2d(c, pyramid_channels, 1)
                                       for c in in_channels])
        self.seg_blocks = nn.ModuleList([
            nn.Sequential(ConvBNAct(pyramid_channels, segmentation_channels, dtype=dtype),
                          ConvBNAct(segmentation_channels, segmentation_channels,
                                    dtype=dtype))
            for _ in in_channels])
        row_split(self.seg_blocks[0][1][0])
        self.dropout = dropout
        self.dtype = dtype

    def forward(self, feats: List[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        laterals = [conv(f, m, self.dtype) for f, m in zip(feats, self.laterals)]
        pyramid = [laterals[-1]]                       # top-down
        for lat in laterals[-2::-1]:
            pyramid.append(lat + resize_bilinear_nchw(pyramid[-1], lat.shape[2:]).to(lat.dtype))
        pyramid = pyramid[::-1]
        size = pyramid[0].shape[2:]
        merged = None
        for p, block in zip(pyramid, self.seg_blocks):
            s = block(p)
            s = resize_bilinear_nchw(s, size).to(s.dtype)
            merged = s if merged is None else merged + s
        return dropout(merged, self.dropout, generator) if self.training else merged


class FCN(NHWCModel):
    """FPN(resnet18, encoder depth 4), the reference's `fcn` slot."""

    def __init__(self, num_classes: int = 3, encoder_name: str = "resnet18",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        encoder = ResNetEncoder(encoder_name, 4, dtype)
        self.model = nn.ModuleDict({
            "encoder": encoder,
            "decoder": FPNHead(encoder.out_channels[1:], dtype=dtype),
            "segmentation_head": nn.Sequential(nn.Conv2d(128, num_classes, 1)),
        })
        self.dtype = dtype

    def logits(self, x, generator: Optional[torch.Generator] = None):
        y = self.model["decoder"](self.model["encoder"](x)[1:], generator)
        logits = conv(y, self.model["segmentation_head"][0], self.dtype).float()
        return resize_bilinear_nchw(logits, x.shape[2:])
