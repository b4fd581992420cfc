"""LinkNet, ported from `enhanced_unet_tpu/models/linknet.py`: additive-skip
decoding over ResNet-18 (encoder depth 3) and the reference's BasicLinkNet
fallback.

- BasicLinkNet: three single 3x3 ConvBNAct stages (`enc1`..`enc3`) with two
  2x2 pools; `dec3`, a bilinear 2x up plus the s2 feature, `dec2`, a
  bilinear 2x up plus the s1 feature and a 1x1 head (`head`).
- LinkNet: `model.encoder` (torchvision ResNet-18),
  `model.decoder.blocks.{0,1,2}` (LinkNetDecoderBlock, each added to the
  next shallower feature but the last) and `model.segmentation_head.0` (3x3
  with a bias).

The decoder's transposed conv is flax's `nn.ConvTranspose((3, 3),
strides=2, padding="SAME")`, which does not flip its kernel and pads
(2, 1): no torch `padding`/`output_padding` gives that.  It equals
`F.conv_transpose2d` at padding 0 with the flax kernel flipped in H and W,
less the last row and column of the output.  The module holds the weight in
torch's `[Cin, Cout, kh, kw]` layout, flipped, as
`convert.jax_params.state_dict_from_jax` writes it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from enhanced_unet_tpu_torch.models.blocks import (
    ConvBNAct,
    NHWCModel,
    batch_norm,
    conv,
    max_pool_2x2,
    row_split,
)
from enhanced_unet_tpu_torch.models.encoders import ResNetEncoder
from enhanced_unet_tpu_torch.ops.resize import upsample2x_nchw


class BasicLinkNet(NHWCModel):
    def __init__(self, num_classes: int = 3, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.enc1 = ConvBNAct(3, 64, dtype=dtype)
        self.enc2 = ConvBNAct(64, 128, dtype=dtype)
        row_split(self.enc2[0])
        self.enc3 = ConvBNAct(128, 256, dtype=dtype)
        self.dec3 = ConvBNAct(256, 128, dtype=dtype)
        self.dec2 = ConvBNAct(128, 64, dtype=dtype)
        self.head = nn.Conv2d(64, num_classes, 1)
        self.dtype = dtype

    def logits(self, x, generator: Optional[torch.Generator] = None):
        e1 = self.enc1(x)
        e2 = self.enc2(max_pool_2x2(e1))
        e3 = self.enc3(max_pool_2x2(e2))
        d2 = self.dec2(upsample2x_nchw(self.dec3(e3)) + e2)
        return conv(upsample2x_nchw(d2) + e1, self.head, self.dtype)


def conv_transpose_same(x: torch.Tensor, layer: nn.ConvTranspose2d,
                        dtype: torch.dtype) -> torch.Tensor:
    """flax's stride-2 3x3 "SAME" transposed conv, in `dtype`: [N,C,H,W] ->
    [N,Cout,2H,2W] (`layer.weight` holds the flipped flax kernel)."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    y = F.conv_transpose2d(x.to(dtype), layer.weight.to(dtype), bias, stride=2)
    return y[:, :, :-1, :-1]


class LinkNetDecoderBlock(nn.Module):
    """1x1 ConvBNAct to a quarter of the channels (`conv1`), the transposed
    conv 2x up (`up`) with BN (`bn`) and ReLU, a 1x1 ConvBNAct out
    (`conv2`)."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        mid = cin // 4
        self.conv1 = ConvBNAct(cin, mid, 1, dtype=dtype)
        self.up = nn.ConvTranspose2d(mid, mid, 3, stride=2)
        self.bn = nn.BatchNorm2d(mid)
        self.conv2 = ConvBNAct(mid, cout, 1, dtype=dtype)
        row_split(self.conv2[0])
        self.dtype = dtype

    def forward(self, x):
        y = conv_transpose_same(self.conv1(x), self.up, self.dtype)
        return self.conv2(torch.relu(batch_norm(y, self.bn)))


class LinkNet(NHWCModel):
    """resnet18-backed LinkNet (encoder depth 3)."""

    def __init__(self, num_classes: int = 3, encoder_name: str = "resnet18",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        encoder = ResNetEncoder(encoder_name, 3, dtype)
        ch = encoder.out_channels               # [3, s2, s4, s8]
        self.model = nn.ModuleDict({
            "encoder": encoder,
            "decoder": nn.ModuleDict({"blocks": nn.ModuleList([
                LinkNetDecoderBlock(ch[3], ch[2], dtype),
                LinkNetDecoderBlock(ch[2], ch[1], dtype),
                LinkNetDecoderBlock(ch[1], 32, dtype)])}),
            "segmentation_head": nn.Sequential(nn.Conv2d(32, num_classes, 3, padding=1)),
        })
        self.dtype = dtype

    def logits(self, x, generator: Optional[torch.Generator] = None):
        feats = self.model["encoder"](x)
        blocks = self.model["decoder"]["blocks"]
        y = blocks[0](feats[-1]) + feats[-2]
        y = blocks[1](y) + feats[-3]
        y = blocks[2](y)
        return conv(y, self.model["segmentation_head"][0], self.dtype)
