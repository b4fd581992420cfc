"""EfficientNet feature encoder, ported from
`enhanced_unet_tpu/models/encoders.py` (DepthwiseConv, MBConvBlock,
EfficientNetEncoder).  Parameter names follow efficientnet-pytorch
(`_conv_stem`, `_bn0`, `_blocks.{i}._depthwise_conv`, ...), the layout of
smp's EfficientNet encoders.

The encoder emits smp's feature pyramid [input, s2, s4, s8, s16, s32].
Stride-2 convs use TF SAME padding (asymmetric: (0, 1) for k3 and (1, 2)
for k5 on even input).  At output stride 16, stages 5-6 keep stride 1 and
dilate their depthwise convs by 2, padded symmetrically.  At inference the
stride-1 3x3 blocks of stage 0 run the fused MBConv kernel.
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from enhanced_unet_tpu_torch.models.blocks import batch_norm, conv
from enhanced_unet_tpu_torch.ops.kernels.mbconv import (
    fold_mbconv_weights,
    mbconv_infer_nchw,
)

# base (B0) stage spec: (expand_ratio, channels, repeats, stride, kernel)
_EFFNET_BASE = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)

# (width_mult, depth_mult); "efficientnet-tiny" is the JAX package's
# structure-identical minimal variant used by the parity tests
_EFFNET_SCALE = {
    "efficientnet-tiny": (0.25, 0.25),
    "efficientnet-b0": (1.0, 1.0),
    "efficientnet-b1": (1.0, 1.1),
    "efficientnet-b2": (1.1, 1.2),
    "efficientnet-b3": (1.2, 1.4),
    "efficientnet-b4": (1.4, 1.8),
    "efficientnet-b5": (1.6, 2.2),
    "efficientnet-b6": (1.8, 2.6),
    "efficientnet-b7": (2.0, 3.1),
}

_BN_EPS = 1e-3      # efficientnet-pytorch BatchNorm eps
_BN_MOMENTUM = 0.01


def _round_filters(c: int, width_mult: float, divisor: int = 8) -> int:
    c *= width_mult
    new_c = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * c:
        new_c += divisor
    return int(new_c)


def _round_repeats(r: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * r))


def expand_ratios(variant: str) -> List[int]:
    """Expand ratio of each block, in `_blocks` order."""
    _, depth_mult = _EFFNET_SCALE[variant]
    out: List[int] = []
    for e, _, r, _, _ in _EFFNET_BASE:
        out.extend([e] * _round_repeats(r, depth_mult))
    return out


def tf_same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """TF/XLA SAME padding for a k x k conv at stride s (extra pixel at the
    bottom/right)."""
    ih, iw = x.shape[-2:]
    ph = max((math.ceil(ih / s) - 1) * s + k - ih, 0)
    pw = max((math.ceil(iw / s) - 1) * s + k - iw, 0)
    return F.pad(x, [pw // 2, pw - pw // 2, ph // 2, ph - ph // 2])


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=_BN_EPS, momentum=_BN_MOMENTUM)


class MBConvBlock(nn.Module):
    """Mobile inverted bottleneck with squeeze-excitation.

    `fused=True` (stride 1, kernel 3, undilated) runs the two-pass fused
    MBConv kernel; otherwise the stock PyTorch path runs."""

    def __init__(self, cin: int, cout: int, expand_ratio: int, stride: int,
                 kernel: int, dilation: int = 1, se_ratio: float = 0.25,
                 fused: bool = False, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        mid = cin * expand_ratio
        if expand_ratio != 1:
            self._expand_conv = nn.Conv2d(cin, mid, 1, bias=False)
            self._bn0 = _bn(mid)
        self._depthwise_conv = nn.Conv2d(mid, mid, kernel, stride, groups=mid,
                                         dilation=dilation, bias=False)
        self._bn1 = _bn(mid)
        se_c = max(1, int(cin * se_ratio))
        self._se_reduce = nn.Conv2d(mid, se_c, 1)
        self._se_expand = nn.Conv2d(se_c, mid, 1)
        self._project_conv = nn.Conv2d(mid, cout, 1, bias=False)
        self._bn2 = _bn(cout)
        if fused and (stride != 1 or kernel != 3 or dilation != 1):
            raise ValueError("the fused MBConv kernel takes stride-1 3x3 blocks")
        self.expand_ratio, self.stride, self.kernel = expand_ratio, stride, kernel
        self.dilation = dilation
        self.residual = stride == 1 and cin == cout
        self.fused = fused
        self.dtype = dtype

    def fold(self):
        """Folded weights for the fused kernel."""
        def stats(bn):
            return bn.weight, bn.bias, bn.running_mean, bn.running_var

        expand = self.expand_ratio != 1
        return fold_mbconv_weights(
            self._expand_conv.weight if expand else None,
            stats(self._bn0) if expand else None,
            self._depthwise_conv.weight, stats(self._bn1),
            (self._se_reduce.weight, self._se_reduce.bias),
            (self._se_expand.weight, self._se_expand.bias),
            self._project_conv.weight, stats(self._bn2),
            eps=_BN_EPS, dtype=self.dtype)

    def forward(self, x):
        if self.fused:
            return mbconv_infer_nchw(x.to(self.dtype), self.fold(),
                                     residual=self.residual)
        dt = self.dtype
        y = x
        if self.expand_ratio != 1:
            y = F.silu(batch_norm(conv(y, self._expand_conv, dt), self._bn0))
        if self.dilation > 1:
            p = (self.kernel // 2) * self.dilation
            y = F.pad(y, [p, p, p, p])
        else:
            y = tf_same_pad(y, self.kernel, self.stride)
        y = F.silu(batch_norm(conv(y, self._depthwise_conv, dt, padding=0),
                              self._bn1))
        s = y.mean(dim=(2, 3), keepdim=True)
        s = conv(F.silu(conv(s, self._se_reduce, dt)), self._se_expand, dt)
        y = y * torch.sigmoid(s)
        y = batch_norm(conv(y, self._project_conv, dt), self._bn2)
        if self.residual:
            y = y + x
        return y


class EfficientNetEncoder(nn.Module):
    """EfficientNet feature pyramid [input, s2, s4, s8, s16, s32] on NCHW
    input.  The stride-2 feature is the stem output (smp's stage
    boundary)."""

    def __init__(self, variant: str = "efficientnet-b5", output_stride: int = 32,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        width_mult, depth_mult = _EFFNET_SCALE[variant]
        stem_c = _round_filters(32, width_mult)
        self._conv_stem = nn.Conv2d(3, stem_c, 3, 2, bias=False)
        self._bn0 = _bn(stem_c)
        tap_stages = {2, 3, 5}
        dilated_stages = {5, 6} if output_stride == 16 else set()
        blocks = []
        self._taps = []                 # block indices whose INPUT is a feature
        self.out_channels = [3, stem_c]
        cin = stem_c
        for stage, (e, c, r, s, k) in enumerate(_EFFNET_BASE):
            cout = _round_filters(c, width_mult)
            for b in range(_round_repeats(r, depth_mult)):
                if b == 0 and stage in tap_stages:
                    self._taps.append(len(blocks))
                    self.out_channels.append(cin)
                stride = s if b == 0 else 1
                dilation = 1
                if stage in dilated_stages:
                    stride, dilation = 1, 2
                fused = stage == 0 and k == 3 and stride == 1 and dilation == 1
                blocks.append(MBConvBlock(cin, cout, e, stride, k, dilation,
                                          fused=fused, dtype=dtype))
                cin = cout
        self.out_channels.append(cin)
        self._blocks = nn.ModuleList(blocks)
        self.dtype = dtype

    def forward(self, x) -> List[torch.Tensor]:
        feats = [x]
        y = conv(tf_same_pad(x, 3, 2), self._conv_stem, self.dtype)
        y = F.silu(batch_norm(y, self._bn0))
        feats.append(y)
        for i, blk in enumerate(self._blocks):
            if i in self._taps:
                feats.append(y)
            if y.is_cuda and not blk.fused:
                y = y.contiguous(memory_format=torch.channels_last)
            y = blk(y)
        feats.append(y)
        return feats
