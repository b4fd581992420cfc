"""Plain fp32 reference of the flagship: the reference repository's
EnhancedUNet (models.py:246-343) as segmentation_models_pytorch 0.3
builds it, UnetPlusPlus(efficientnet-b5, scSE) beside DeepLabV3Plus
(efficientnet-b4, output stride 16), an attention gate, a three-conv
fusion head and a 1x1 residual.

A frozen copy of the repository's state-dict-exact smp mirror
(`tests/smp_mirror.py`), in plain torch, under the same parameter names.
Train mode adds the regularisers that the JAX package defines and the port
follows: stochastic depth on the encoders' residual blocks (rate
0.2 * i / n for block i of n), element-wise dropout after the ASPP
projection (0.5) and after the fusion head's first two layers (0.2, 0.15),
each drawn from the caller's generator in the program's order: the UNet++
encoder's blocks, the DeepLab encoder's, the ASPP, the fusion head.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.common import (
    Conv2d,
    drop_path,
    dropout,
    effnet_round_filters,
    effnet_round_repeats,
)

# EfficientNet-B0's stages (expand, channels, repeats, stride, kernel) and
# the (width, depth) multipliers of the variants used here
EFFNET_BASE = ((1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5), (6, 80, 3, 2, 3),
               (6, 112, 3, 1, 5), (6, 192, 4, 2, 5), (6, 320, 1, 1, 3))
EFFNET_SCALE = {"efficientnet-tiny": (0.25, 0.25), "efficientnet-b4": (1.4, 1.8),
                "efficientnet-b5": (1.6, 2.2)}
DROP_CONNECT = 0.2


def bn(c: int, eps: float = 1e-5) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=eps)


def tf_same_pad(x, k, s):
    ih, iw = x.shape[-2:]
    ph = max((-(-ih // s) - 1) * s + k - ih, 0)
    pw = max((-(-iw // s) - 1) * s + k - iw, 0)
    return F.pad(x, [pw // 2, pw - pw // 2, ph // 2, ph - ph // 2])


class SCSEModule(nn.Module):
    def __init__(self, c, reduction=16):
        super().__init__()
        mid = max(c // reduction, 1)
        self.cSE = nn.Sequential(nn.AdaptiveAvgPool2d(1), Conv2d(c, mid, 1), nn.ReLU(),
                                 Conv2d(mid, c, 1), nn.Sigmoid())
        self.sSE = nn.Sequential(Conv2d(c, 1, 1), nn.Sigmoid())

    def forward(self, x):
        return x * self.cSE(x) + x * self.sSE(x)


class Attention(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.attention = SCSEModule(c)

    def forward(self, x):
        return self.attention(x)


def conv_bn_relu(cin, cout, k=3):
    return nn.Sequential(Conv2d(cin, cout, k, padding=k // 2, bias=False), bn(cout), nn.ReLU())


class SeparableConv2d(nn.Sequential):
    def __init__(self, cin, cout, dilation=1):
        super().__init__(Conv2d(cin, cin, 3, padding=dilation, dilation=dilation,
                                groups=cin, bias=False),
                         Conv2d(cin, cout, 1, bias=False))


class DecoderBlock(nn.Module):
    def __init__(self, cin, skip, cout):
        super().__init__()
        self.conv1 = conv_bn_relu(cin + skip, cout)
        self.attention1 = Attention(cin + skip)
        self.conv2 = conv_bn_relu(cout, cout)
        self.attention2 = Attention(cout)

    def forward(self, x, skip=None):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        if skip is not None:
            x = self.attention1(torch.cat([x, skip], dim=1))
        return self.attention2(self.conv2(self.conv1(x)))


class UnetPlusPlusDecoder(nn.Module):
    def __init__(self, encoder_channels, decoder_channels):
        super().__init__()
        enc = list(encoder_channels[1:])[::-1]
        self.in_channels = [enc[0]] + list(decoder_channels[:-1])
        self.skip_channels = enc[1:] + [0]
        blocks = {}
        for layer in range(len(self.in_channels) - 1):
            for depth in range(layer + 1):
                if depth == 0:
                    cin, cout = self.in_channels[layer], decoder_channels[layer]
                    skip = self.skip_channels[layer] * (layer + 1)
                else:
                    cout = self.skip_channels[layer]
                    skip = self.skip_channels[layer] * (layer + 1 - depth)
                    cin = self.skip_channels[layer - 1]
                blocks[f"x_{depth}_{layer}"] = DecoderBlock(cin, skip, cout)
        self.depth = len(self.in_channels) - 1
        blocks[f"x_0_{self.depth}"] = DecoderBlock(self.in_channels[-1], 0,
                                                   decoder_channels[-1])
        self.blocks = nn.ModuleDict(blocks)

    def forward(self, *features):
        features = features[1:][::-1]
        dense = {}
        for layer in range(len(self.in_channels) - 1):
            for depth in range(self.depth - layer):
                if layer == 0:
                    dense[f"x_{depth}_{depth}"] = self.blocks[f"x_{depth}_{depth}"](
                        features[depth], features[depth + 1])
                else:
                    li = depth + layer
                    cat = torch.cat([dense[f"x_{i}_{li}"] for i in range(depth + 1, li + 1)]
                                    + [features[li + 1]], dim=1)
                    dense[f"x_{depth}_{li}"] = self.blocks[f"x_{depth}_{li}"](
                        dense[f"x_{depth}_{li - 1}"], cat)
        return self.blocks[f"x_0_{self.depth}"](dense[f"x_0_{self.depth - 1}"])


class MBConv(nn.Module):
    """efficientnet-pytorch's MBConvBlock (BN eps 1e-3), TF SAME padding,
    symmetric padding where dilated; stochastic depth on the residual."""

    def __init__(self, cin, cout, expand, stride, k, dilation=1, drop_rate=0.0):
        super().__init__()
        self.stride, self.k, self.dilation, self.expand = stride, k, dilation, expand
        self.has_skip = stride == 1 and cin == cout
        self.drop_rate = drop_rate
        mid = cin * expand
        if expand != 1:
            self._expand_conv = Conv2d(cin, mid, 1, bias=False)
            self._bn0 = bn(mid, 1e-3)
        self._depthwise_conv = Conv2d(mid, mid, k, stride, groups=mid, bias=False,
                                      dilation=dilation)
        self._bn1 = bn(mid, 1e-3)
        se_c = max(1, int(cin * 0.25))
        self._se_reduce = Conv2d(mid, se_c, 1)
        self._se_expand = Conv2d(se_c, mid, 1)
        self._project_conv = Conv2d(mid, cout, 1, bias=False)
        self._bn2 = bn(cout, 1e-3)

    def forward(self, x, generator=None):
        y = x
        if self.expand != 1:
            y = F.silu(self._bn0(self._expand_conv(y)))
        if self.dilation > 1:
            p = (self.k // 2) * self.dilation
            y = F.pad(y, [p, p, p, p])
        else:
            y = tf_same_pad(y, self.k, self.stride)
        y = F.silu(self._bn1(self._depthwise_conv(y)))
        s = self._se_expand(F.silu(self._se_reduce(y.mean((2, 3), keepdim=True))))
        y = self._bn2(self._project_conv(y * torch.sigmoid(s)))
        if self.has_skip:
            if self.training and self.drop_rate > 0.0:
                y = drop_path(y, self.drop_rate, generator)
            y = y + x
        return y


class EfficientNet(nn.Module):
    """efficientnet-pytorch layout emitting smp's pyramid [input, stem,
    after stages 1, 2, 4, end]; output stride 16 dilates stages 5-6."""

    def __init__(self, variant, output_stride=32):
        super().__init__()
        wm, dm = EFFNET_SCALE[variant]
        stem_c = effnet_round_filters(32, wm)
        self._conv_stem = Conv2d(3, stem_c, 3, 2, bias=False)
        self._bn0 = bn(stem_c, 1e-3)
        specs, self._capture = [], []
        cin = stem_c
        dilated = {5, 6} if output_stride == 16 else set()
        for si, (e, c, r, s, k) in enumerate(EFFNET_BASE):
            cout = effnet_round_filters(c, wm)
            for b in range(effnet_round_repeats(r, dm)):
                if b == 0 and si in (2, 3, 5):
                    self._capture.append(len(specs))
                stride, dilation = (1, 2) if si in dilated else (s if b == 0 else 1, 1)
                specs.append((cin, cout, e, stride, k, dilation))
                cin = cout
        self.out_channels = [3, stem_c] + [specs[i][0] for i in self._capture] + [cin]
        self._blocks = nn.ModuleList([
            MBConv(*spec, drop_rate=DROP_CONNECT * i / len(specs))
            for i, spec in enumerate(specs)])

    def forward(self, x, generator=None):
        feats = [x]
        y = F.silu(self._bn0(self._conv_stem(tf_same_pad(x, 3, 2))))
        feats.append(y)
        for i, blk in enumerate(self._blocks):
            if i in self._capture:
                feats.append(y)
            y = blk(y, generator)
        feats.append(y)
        return feats


class ASPP(nn.Module):
    def __init__(self, cin, cout=256, rates=(12, 24, 36), drop=0.5):
        super().__init__()
        sep = [nn.Sequential(SeparableConv2d(cin, cout, r), bn(cout), nn.ReLU()) for r in rates]
        pool = nn.Sequential(nn.AdaptiveAvgPool2d(1), Conv2d(cin, cout, 1, bias=False),
                             bn(cout), nn.ReLU())
        self.convs = nn.ModuleList([conv_bn_relu(cin, cout, 1)] + sep + [pool])
        self.project = conv_bn_relu(5 * cout, cout, 1)
        self.drop = drop

    def forward(self, x, generator=None):
        res = [m(x) for m in self.convs[:4]]
        res.append(self.convs[4](x).expand(-1, -1, *x.shape[2:]))
        y = self.project(torch.cat(res, dim=1))
        return dropout(y, self.drop, generator) if self.training else y


class DeepLabV3PlusDecoder(nn.Module):
    def __init__(self, encoder_channels, cout=256):
        super().__init__()
        self.aspp = nn.Sequential(ASPP(encoder_channels[-1], cout), SeparableConv2d(cout, cout),
                                  bn(cout), nn.ReLU())
        self.block1 = conv_bn_relu(encoder_channels[-4], 48, 1)
        self.block2 = nn.Sequential(SeparableConv2d(48 + cout, cout), bn(cout), nn.ReLU())

    def forward(self, *features, generator=None):
        a = self.aspp[0](features[-1], generator)
        for m in self.aspp[1:]:
            a = m(a)
        low = features[-4]
        a = F.interpolate(a, size=low.shape[2:], mode="bilinear", align_corners=True)
        return self.block2(torch.cat([a, self.block1(low)], dim=1))


class UnetPlusPlus(nn.Module):
    def __init__(self, encoder, classes, decoder_channels=(256, 128, 64, 32, 16)):
        super().__init__()
        self.encoder = EfficientNet(encoder)
        self.decoder = UnetPlusPlusDecoder(self.encoder.out_channels, decoder_channels)
        self.segmentation_head = nn.Sequential(
            Conv2d(decoder_channels[-1], classes, 3, padding=1))

    def forward(self, x, generator=None):
        return self.segmentation_head(self.decoder(*self.encoder(x, generator)))


class DeepLabV3Plus(nn.Module):
    def __init__(self, encoder, classes):
        super().__init__()
        self.encoder = EfficientNet(encoder, output_stride=16)
        self.decoder = DeepLabV3PlusDecoder(self.encoder.out_channels)
        self.segmentation_head = nn.Sequential(Conv2d(256, classes, 1))

    def forward(self, x, generator=None):
        y = self.decoder(*self.encoder(x, generator), generator=generator)
        return F.interpolate(self.segmentation_head(y), size=x.shape[2:], mode="bilinear",
                             align_corners=True)


class EnhancedUNet(nn.Module):
    """`model(x_nchw, generator=None) -> (logits, {"unetpp", "deeplab"})`,
    all NCHW fp32."""

    def __init__(self, num_classes=3, encoders=("efficientnet-b5", "efficientnet-b4"),
                 fusion_dropout=(0.2, 0.15)):
        super().__init__()
        self.unetpp = UnetPlusPlus(encoders[0], num_classes)
        self.deeplab = DeepLabV3Plus(encoders[1], num_classes)
        fc = 2 * num_classes
        self.attention_gate = nn.Sequential(
            Conv2d(fc, fc // 2, 3, padding=1, bias=False), bn(fc // 2), nn.GELU(),
            Conv2d(fc // 2, fc, 1, bias=False), bn(fc), nn.Sigmoid())
        self.fusion_head = nn.Sequential(
            Conv2d(fc, 256, 3, padding=1, bias=False), bn(256), nn.ReLU(), nn.Identity(),
            Conv2d(256, 128, 3, padding=1, bias=False), bn(128), nn.ReLU(), nn.Identity(),
            Conv2d(128, 64, 3, padding=1, bias=False), bn(64), nn.ReLU(),
            Conv2d(64, num_classes, 1))
        self.fusion_residual = Conv2d(fc, num_classes, 1)
        self.fusion_dropout = fusion_dropout

    def forward(self, x, generator: Optional[torch.Generator] = None):
        out_main = self.unetpp(x, generator)
        out_aux = self.deeplab(x, generator)
        fused = torch.cat([out_main, out_aux], dim=1)
        fused = fused * self.attention_gate(fused)
        y = fused
        head = self.fusion_head
        for k, start in enumerate((0, 4, 8)):
            y = head[start + 2](head[start + 1](head[start](y)))
            if self.training and k < 2:
                y = dropout(y, self.fusion_dropout[k], generator)
        logits = head[11](y) + self.fusion_residual(fused)
        return logits, {"unetpp": out_main, "deeplab": out_aux}


def build(config: dict) -> nn.Module:
    """The reference model of a configuration file's `model_kwargs`."""
    kw = config.get("model_kwargs", {})
    return EnhancedUNet(config.get("num_classes", 3),
                        tuple(kw.get("encoder_names", ("efficientnet-b5", "efficientnet-b4"))),
                        tuple(kw.get("fusion_dropout", (0.2, 0.15))))
