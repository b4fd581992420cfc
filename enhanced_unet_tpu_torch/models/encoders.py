"""Feature encoders, ported from `enhanced_unet_tpu/models/encoders.py`:
ResNet-18/34/50 (BasicResBlock, BottleneckResBlock, ResNetEncoder) and
EfficientNet (MBConvBlock, EfficientNetEncoder), with `build_encoder`.

Parameter names are the upstream ones that smp's encoders hold:
torchvision's for the ResNets (`conv1`, `bn1`, `layer{i}.{b}.conv{k}`,
`layer{i}.{b}.bn{k}`, `layer{i}.{b}.downsample.{0,1}`), efficientnet-pytorch's
for the EfficientNets (`_conv_stem`, `_bn0`, `_blocks.{i}._depthwise_conv`,
...).  So `enhanced_unet_tpu.convert.torch_import` reads a port encoder's
state dict as it reads an upstream file.

Each encoder emits smp's feature pyramid [input, s2, s4, s8, s16, s32].
ResNet convs pad symmetrically (`k // 2`, torchvision's); their eval-mode
3x3 stride-1 convs run the fused conv3x3+BN+ReLU kernel (`conv_bn_act`).
Stride-2 convs use TF SAME padding (asymmetric: (0, 1) for k3 and (1, 2)
for k5 on even input).  At output stride 16, stages 5-6 keep stride 1 and
dilate their depthwise convs by 2, padded symmetrically.  In eval mode the
stride-1 3x3 blocks of stage 0 run the fused MBConv kernel, and the dilated
blocks' depthwise conv, BN and SiLU run as one kernel on channels_last
tensors (`ops/kernels/depthwise.py` `dw_dilated_bn_silu_nhwc`, the padding
inside it, BN folded into cached weights); nothing on the serving path calls
the older NCHW depthwise kernels of that module.  Train mode runs every block
on the stock path, with stochastic depth on the residual blocks; so do
blocks under a partitioned run (`ops.partition`), whose modes intercept the
stock convs and pads for their halos and slices.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from enhanced_unet_tpu_torch.models.blocks import (
    batch_norm,
    cached_weights,
    conv,
    conv_bn_act,
    need_generator,
    refuse_autograd,
    row_split,
)
from enhanced_unet_tpu_torch.ops import partition
from enhanced_unet_tpu_torch.ops.kernels.depthwise import (
    DwFolded,
    dw_dilated_bn_silu_nhwc,
    fold_dw_bn,
)
from enhanced_unet_tpu_torch.ops.kernels.mbconv import (
    MBConvWeights,
    fold_mbconv_weights,
    mbconv_infer_nchw,
)


def _downsample(cin: int, cout: int, stride: int) -> Optional[nn.Sequential]:
    """torchvision's shortcut projection (1x1 stride-s conv, BN), where the
    block changes the shape."""
    if stride == 1 and cin == cout:
        return None
    return nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False), nn.BatchNorm2d(cout))


def _shortcut(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    ds = block.downsample
    return x if ds is None else conv_bn_act(x, ds[0], ds[1], False, block.dtype)


class BasicResBlock(nn.Module):
    """torchvision's BasicBlock: 3x3 (stride s) -> BN -> ReLU -> 3x3 -> BN,
    plus the input (projected where the shape changes), then ReLU."""

    expansion = 1

    def __init__(self, cin: int, width: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, width, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = row_split(nn.Conv2d(width, width, 3, 1, 1, bias=False))
        self.bn2 = nn.BatchNorm2d(width)
        self.downsample = _downsample(cin, width, stride)
        self.dtype = dtype

    def forward(self, x):
        y = conv_bn_act(x, self.conv1, self.bn1, True, self.dtype)
        y = conv_bn_act(y, self.conv2, self.bn2, False, self.dtype)
        return torch.relu(y + _shortcut(self, x))


class BottleneckResBlock(nn.Module):
    """torchvision's Bottleneck (v1.5: the stride on the 3x3): 1x1 -> 3x3
    (stride s) -> 1x1 to 4x the width, each with BN, ReLU between; plus the
    input (projected where the shape changes), then ReLU."""

    expansion = 4

    def __init__(self, cin: int, width: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = row_split(nn.Conv2d(width, width, 3, stride, 1, bias=False))
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, width * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(width * 4)
        self.downsample = _downsample(cin, width * 4, stride)
        self.dtype = dtype

    def forward(self, x):
        y = conv_bn_act(x, self.conv1, self.bn1, True, self.dtype)
        y = conv_bn_act(y, self.conv2, self.bn2, True, self.dtype)
        y = conv_bn_act(y, self.conv3, self.bn3, False, self.dtype)
        return torch.relu(y + _shortcut(self, x))


RESNET_SPECS = {
    "resnet18": (BasicResBlock, (2, 2, 2, 2)),
    "resnet34": (BasicResBlock, (3, 4, 6, 3)),
    "resnet50": (BottleneckResBlock, (3, 4, 6, 3)),
}


class ResNetEncoder(nn.Module):
    """torchvision ResNet trunk emitting [input, s2, s4, s8, s16, s32], cut
    at `depth` (smp's encoder_depth): stages past it are not built.  The
    stride-2 feature is the stem's ReLU output; the 3x3/2 max pool after it
    pads with -inf."""

    def __init__(self, variant: str = "resnet50", depth: int = 5,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        block, layers = RESNET_SPECS[variant]
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.out_channels = [3, 64]
        cin = 64
        for stage, (width, n) in enumerate(zip((64, 128, 256, 512), layers)):
            if stage + 2 > depth:
                break
            blocks = []
            for b in range(n):
                blocks.append(block(cin, width, 2 if (b == 0 and stage > 0) else 1, dtype))
                cin = width * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
            self.out_channels.append(cin)
        self.variant, self.depth = variant, depth
        self.dtype = dtype

    @property
    def n_stages(self) -> int:
        return len(self.out_channels) - 2

    def forward(self, x, generator: Optional[torch.Generator] = None
                ) -> List[torch.Tensor]:
        del generator  # no random draws
        feats = [x]
        y = conv_bn_act(x, self.conv1, self.bn1, True, self.dtype)
        feats.append(y)
        if self.depth < 2:
            return feats
        y = F.max_pool2d(y, 3, 2, 1)
        for stage in range(self.n_stages):
            y = getattr(self, f"layer{stage + 1}")(y)
            feats.append(y)
        return feats


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


def drop_path(y: torch.Tensor, rate: float,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    """Stochastic depth of a residual branch, per sample: the sample's
    branch is kept when `floor(keep + U)` is 1 (U uniform, keep = 1 - rate)
    and scaled by 1 / keep.  Under tensor parallelism (`ops.partition`) a
    rank keeps its samples' part of the draws over the whole batch."""
    keep = 1.0 - rate
    generator = need_generator(generator, "stochastic depth")
    part = partition.active()
    u = (torch.rand((y.shape[0], 1, 1, 1), device=y.device, generator=generator)
         if part is None else part.uniform(y, generator, per_sample=True))
    return y / keep * torch.floor(keep + u).to(y.dtype)


class MBConvBlock(nn.Module):
    """Mobile inverted bottleneck with squeeze-excitation.

    `fused=True` (stride 1, kernel 3, undilated) runs the two-pass fused
    MBConv kernel in eval mode.  A dilated block in eval mode, outside a
    partitioned run, runs its depthwise conv, BN and SiLU as one kernel
    (`dw_dilated_bn_silu_nhwc`, weights from `dw_fold`); the expand and
    project convs and the SE gate stay stock.  Otherwise, and always in
    train mode, the stock PyTorch path runs.  `drop_rate` is the
    stochastic-depth rate of a residual block in train mode."""

    def __init__(self, cin: int, cout: int, expand_ratio: int, stride: int,
                 kernel: int, dilation: int = 1, se_ratio: float = 0.25,
                 fused: bool = False, drop_rate: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16):
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
        self.cin, self.cout = cin, cout
        self.expand_ratio, self.stride, self.kernel = expand_ratio, stride, kernel
        self.dilation = dilation
        self.residual = stride == 1 and cin == cout
        self.fused = fused
        self.drop_rate = drop_rate
        self.dtype = dtype

    def fold(self, whole=None) -> MBConvWeights:
        """Folded weights for the fused kernel, on the parameters' device
        in the compute dtype, folded once and kept on the module.  They are
        folded again when a conv or BN tensor is replaced or edited in place
        (`load_state_dict`, `.to()`, `running_mean.add_`: a new `data_ptr`
        or `_version`), or for another dtype or device.  A block that holds
        a channel slice of a weight (tensor parallelism, `ops.partition`)
        folds from `whole(t)`, each tensor whole, on every call and keeps
        nothing; without `whole` it raises `ValueError`.  Each folding counts
        `kernels.k1_fold` (`utils.profiler`)."""
        def stats(bn):
            return bn.weight, bn.bias, bn.running_mean, bn.running_var

        expand = self.expand_ratio != 1
        bns = [self._bn0, self._bn1, self._bn2] if expand else [self._bn1, self._bn2]
        tensors = [self._depthwise_conv.weight, self._se_reduce.weight,
                   self._se_reduce.bias, self._se_expand.weight, self._se_expand.bias,
                   self._project_conv.weight] + [t for bn in bns for t in stats(bn)]
        if expand:
            tensors.append(self._expand_conv.weight)
        sliced = any(partition.split_of(t) is not None for t in tensors)
        if sliced and whole is None:
            raise ValueError(f"MBConvBlock {self.cin}->{self.cout} holds channel slices of "
                             "its weights: fold it from its weights gathered whole")
        w = whole if sliced else (lambda t: t)
        return cached_weights(
            self, "_folded", tensors, "kernels.k1_fold", lambda: fold_mbconv_weights(
                w(self._expand_conv.weight) if expand else None,
                stats(self._bn0) if expand else None,
                w(self._depthwise_conv.weight), stats(self._bn1),
                (w(self._se_reduce.weight), self._se_reduce.bias),
                (w(self._se_expand.weight), self._se_expand.bias),
                w(self._project_conv.weight), stats(self._bn2),
                eps=_BN_EPS, dtype=self.dtype), keep=not sliced)

    def dw_fold(self) -> DwFolded:
        """BN1 folded into the depthwise weights for the dilated kernel, in
        the compute dtype on the parameters' device, kept on the module and
        folded again as `fold`'s are; each folding counts `kernels.dw_fold`
        (`utils.profiler`)."""
        bn = self._bn1
        tensors = [self._depthwise_conv.weight, bn.weight, bn.bias, bn.running_mean,
                   bn.running_var]
        return cached_weights(self, "_dw_folded", tensors, "kernels.dw_fold",
                              lambda: fold_dw_bn(tensors[0], tensors[1:], _BN_EPS, self.dtype))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if self.fused and not self.training:
            refuse_autograd(f"fused MBConvBlock {self.cin}->{self.cout}",
                            self.parameters())

            def run(xk, weights, own=None):
                # on a haloed band pass 1 sums the band's own rows,
                # all-reduced; the gate divides by the whole map's pixels
                rows = {} if own is None else dict(rows=own.rows, reduce=own.reduce,
                                                   hw=own.hw)
                return mbconv_infer_nchw(xk.to(self.dtype), weights,
                                         residual=self.residual, **rows)

            part = partition.active()   # a band of rows or a channel slice
            return run(x, self.fold()) if part is None else part.mbconv(x, self, run)
        # the dilated kernel has no backward and no band- or slice-aware call
        dilated = self.dilation > 1 and not self.training and partition.active() is None
        if dilated:
            refuse_autograd(f"dilated MBConvBlock {self.cin}->{self.cout}",
                            self.parameters())
        dt = self.dtype
        y = x
        if self.expand_ratio != 1:
            y = F.silu(batch_norm(conv(y, self._expand_conv, dt), self._bn0))
        if dilated:
            y = dw_dilated_bn_silu_nhwc(y.to(dt), self.dw_fold(), self.dilation)
        else:
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
            if self.training and self.drop_rate > 0.0:
                y = drop_path(y, self.drop_rate, generator)
            y = y + x
        return y


class EfficientNetEncoder(nn.Module):
    """EfficientNet feature pyramid [input, s2, s4, s8, s16, s32] on NCHW
    input.  The stride-2 feature is the stem output (smp's stage
    boundary).  Block i of n has the stochastic-depth rate
    `drop_connect_rate * i / n` (train mode, residual blocks only)."""

    def __init__(self, variant: str = "efficientnet-b5", output_stride: int = 32,
                 drop_connect_rate: float = 0.2, dtype: torch.dtype = torch.bfloat16):
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
        total = sum(_round_repeats(r, depth_mult) for _, _, r, _, _ in _EFFNET_BASE)
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
                blocks.append(MBConvBlock(
                    cin, cout, e, stride, k, dilation, fused=fused,
                    drop_rate=drop_connect_rate * len(blocks) / total, dtype=dtype))
                cin = cout
        self.out_channels.append(cin)
        self._blocks = nn.ModuleList(blocks)
        self.dtype = dtype

    def forward(self, x, generator: Optional[torch.Generator] = None
                ) -> List[torch.Tensor]:
        feats = [x]
        y = conv(tf_same_pad(x, 3, 2), self._conv_stem, self.dtype)
        y = F.silu(batch_norm(y, self._bn0))
        feats.append(y)
        for i, blk in enumerate(self._blocks):
            if i in self._taps:
                feats.append(y)
            if y.is_cuda:
                y = y.contiguous(memory_format=torch.channels_last)
            y = blk(y, generator)
        feats.append(y)
        return feats


def build_encoder(name: str, depth: int = 5, output_stride: int = 32,
                  dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """The encoder `name` (resnet18/34/50 cut at `depth`, or an EfficientNet
    at `output_stride`)."""
    if name.startswith("resnet"):
        return ResNetEncoder(name, depth, dtype)
    if name.startswith("efficientnet"):
        return EfficientNetEncoder(name, output_stride, dtype=dtype)
    raise ValueError(f"unknown encoder {name}")
