"""EnhancedUNet, the flagship dual-branch model, and its non-smp fallback
EnhancedUNetBasic, ported from `enhanced_unet_tpu/models/enhanced_unet.py`
(EnhancedUNetBasic, NestedBlock, UNetPlusPlus, DeepLabV3Plus, EnhancedUNet).

- main branch: UNet++ (nested dense-skip decoder with scSE) over
  EfficientNet-B5;
- aux branch: DeepLabV3+ (separable ASPP, output stride 16) over
  EfficientNet-B4;
- fusion: the two logit maps are concatenated, gated (conv3-BN-GELU-conv1-
  BN-sigmoid), sent through a three-conv head (256 -> 128 -> 64, the fused
  conv3x3+BN+ReLU kernel) and a 1x1 residual.

Parameter names are the reference state dict's (`unetpp.*`, `deeplab.*`,
`attention_gate.*`, `fusion_head.*`, `fusion_residual`), including the head
block's unused `x_0_4.attention1`, so a reference checkpoint loads strictly.
The JAX package's TPU layout options (`packed_decoder`, `packed_fusion`)
are accepted and change nothing: they compute the same math.

Under a profiler a forward records five spans (`utils.profiler`):
`model.unetpp.encoder`, `model.unetpp.decoder` (with its head),
`model.deeplab.encoder`, `model.deeplab.decoder` (with its head and the x4
resize) and `model.fusion` (gate, head, residual).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from enhanced_unet_tpu_torch.models.blocks import (
    ASPP,
    Attention,
    ConvBNAct,
    DoubleConv,
    NHWCModel,
    SeparableConv2d,
    SeparableConvBNAct,
    batch_norm,
    conv,
    conv_bn_act,
    dropout,
    need_generator,
    row_split,
)
from enhanced_unet_tpu_torch.models.encoders import EfficientNetEncoder
from enhanced_unet_tpu_torch.models.unet import BasicUNet
from enhanced_unet_tpu_torch.utils.profiler import span
from enhanced_unet_tpu_torch.ops.resize import (
    resize_bilinear_align_corners_nchw,
    resize_bilinear_nchw,
    upsample2x_nearest_nchw,
)


class EnhancedUNetBasic(NHWCModel):
    """The reference's non-smp EnhancedUNet fallback: a BasicUNet
    (`backbone`) and a residual head on its logits, `out +
    conv1(relu(bn(conv3(out))))` (`enhance.0`, `.1`, `.3`), the 3x3 conv with
    a bias folded into the fused conv3x3+BN+ReLU kernel.  No aux outputs."""

    def __init__(self, num_classes: int = 3, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.backbone = BasicUNet(num_classes, dtype)
        self.enhance = nn.Sequential(
            nn.Conv2d(num_classes, 64, 3, padding=1), nn.BatchNorm2d(64), nn.ReLU(),
            nn.Conv2d(64, num_classes, 1))
        self.dtype = dtype

    def logits(self, x, generator: Optional[torch.Generator] = None):
        out = self.backbone.logits(x, generator).float()
        y = conv_bn_act(out.to(self.dtype), self.enhance[0], self.enhance[1], True,
                        self.dtype)
        return out + conv(y, self.enhance[3], self.dtype).float()


class NestedBlock(DoubleConv):
    """UNet++ node (smp DecoderBlock): nearest 2x up of the node below, concat
    with the skips (newest first, encoder feature last), scSE, two 3x3
    ConvBNActs, scSE.  Without skips (the head block) the first scSE is
    skipped, though its parameters exist.  The first scSE takes the node
    below and the skips as parts (`SCSEBlock`), so where its fused path runs
    neither the upsample nor the concatenation is formed."""

    def __init__(self, cin: int, skip: int, cout: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(cin + skip, cout, dtype)
        self.attention1 = Attention(cin + skip, dtype)
        self.attention2 = Attention(cout, dtype)

    def forward(self, x, skips=()):
        if skips:
            x = self.attention1(x, *(t.to(x.dtype) for t in skips), up=True)
        else:
            x = upsample2x_nearest_nchw(x)
        return self.attention2(super().forward(x))


class UnetPlusPlusDecoder(nn.Module):
    """smp UnetPlusPlusDecoder: intermediate nodes take the encoder skip
    width; node x_{d}_{l} of smp is the port's block of the same name."""

    def __init__(self, encoder_channels: Sequence[int],
                 decoder_channels: Sequence[int],
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        enc = list(encoder_channels[1:])[::-1]
        self.in_channels = [enc[0]] + list(decoder_channels[:-1])
        self.skip_channels = enc[1:] + [0]
        out_channels = list(decoder_channels)
        blocks = {}
        for layer in range(len(self.in_channels) - 1):
            for depth in range(layer + 1):
                if depth == 0:
                    cin = self.in_channels[layer]
                    skip = self.skip_channels[layer] * (layer + 1)
                    cout = out_channels[layer]
                else:
                    cout = self.skip_channels[layer]
                    skip = self.skip_channels[layer] * (layer + 1 - depth)
                    cin = self.skip_channels[layer - 1]
                blocks[f"x_{depth}_{layer}"] = NestedBlock(cin, skip, cout, dtype)
        self.depth = len(self.in_channels) - 1
        blocks[f"x_0_{self.depth}"] = NestedBlock(
            self.in_channels[-1], 0, out_channels[-1], dtype)
        self.blocks = nn.ModuleDict(blocks)

    def forward(self, *features):
        features = features[1:][::-1]
        dense = {}
        for layer in range(len(self.in_channels) - 1):
            for depth in range(self.depth - layer):
                if layer == 0:
                    dense[f"x_{depth}_{depth}"] = self.blocks[f"x_{depth}_{depth}"](
                        features[depth], [features[depth + 1]])
                else:
                    li = depth + layer
                    skips = [dense[f"x_{i}_{li}"].to(features[li + 1].dtype)
                             for i in range(depth + 1, li + 1)] + [features[li + 1]]
                    dense[f"x_{depth}_{li}"] = self.blocks[f"x_{depth}_{li}"](
                        dense[f"x_{depth}_{li - 1}"], skips)
        return self.blocks[f"x_0_{self.depth}"](dense[f"x_0_{self.depth - 1}"])


class UNetPlusPlus(nn.Module):
    """smp.UnetPlusPlus over an EfficientNet encoder; NCHW in, fp32 logits
    at input resolution out."""

    def __init__(self, num_classes: int = 3, encoder_name: str = "efficientnet-b5",
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 drop_connect_rate: float = 0.2, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.encoder = EfficientNetEncoder(
            encoder_name, drop_connect_rate=drop_connect_rate, dtype=dtype)
        self.decoder = UnetPlusPlusDecoder(self.encoder.out_channels,
                                           decoder_channels, dtype)
        self.segmentation_head = nn.Sequential(
            nn.Conv2d(decoder_channels[-1], num_classes, 3, padding=1))
        self.dtype = dtype

    def forward(self, x, generator: Optional[torch.Generator] = None):
        with span("model.unetpp.encoder", device=x.device):
            features = self.encoder(x, generator)
        with span("model.unetpp.decoder", device=x.device):
            y = self.decoder(*features)
            return conv(y, self.segmentation_head[0], self.dtype).float()


class _ASPPHead(nn.Sequential):
    """smp's `decoder.aspp`: ASPP (0), SeparableConv2d (1), BN (2), ReLU."""

    def __init__(self, cin: int, features: int, dropout: float, dtype: torch.dtype):
        super().__init__(ASPP(cin, features, dropout=dropout, dtype=dtype),
                         SeparableConv2d(features, features, 1, dtype),
                         nn.BatchNorm2d(features), nn.ReLU())

    def forward(self, x, generator: Optional[torch.Generator] = None):
        return torch.relu(batch_norm(self[1](self[0](x, generator)), self[2]))


class DeepLabV3PlusDecoder(nn.Module):
    def __init__(self, encoder_channels: Sequence[int], features: int = 256,
                 aspp_dropout: float = 0.5, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.aspp = _ASPPHead(encoder_channels[-1], features, aspp_dropout, dtype)
        self.block1 = ConvBNAct(encoder_channels[-4], 48, 1, dtype=dtype)
        self.block2 = SeparableConvBNAct(48 + features, features, 1, dtype)

    def forward(self, *features, generator: Optional[torch.Generator] = None):
        low = features[-4]
        y = self.aspp(features[-1], generator)
        y = resize_bilinear_align_corners_nchw(y, low.shape[2:]).to(low.dtype)
        return self.block2(torch.cat([y, self.block1(low)], dim=1))


class DeepLabV3Plus(nn.Module):
    """smp.DeepLabV3Plus (output stride 16, align-corners x4 upsamples); NCHW
    in, fp32 logits at input resolution out."""

    def __init__(self, num_classes: int = 3, encoder_name: str = "efficientnet-b4",
                 drop_connect_rate: float = 0.2, aspp_dropout: float = 0.5,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.encoder = EfficientNetEncoder(encoder_name, output_stride=16,
                                           drop_connect_rate=drop_connect_rate,
                                           dtype=dtype)
        self.decoder = DeepLabV3PlusDecoder(self.encoder.out_channels,
                                            aspp_dropout=aspp_dropout, dtype=dtype)
        self.segmentation_head = nn.Sequential(nn.Conv2d(256, num_classes, 1))
        self.dtype = dtype

    def forward(self, x, generator: Optional[torch.Generator] = None):
        with span("model.deeplab.encoder", device=x.device):
            features = self.encoder(x, generator)
        with span("model.deeplab.decoder", device=x.device):
            y = self.decoder(*features, generator=generator)
            logits = conv(y, self.segmentation_head[0], self.dtype).float()
            return resize_bilinear_align_corners_nchw(logits, x.shape[2:])


class EnhancedUNet(nn.Module):
    """Dual-branch fusion model.  `model(x_nhwc, generator=None) ->
    (logits_nhwc_f32, {"unetpp": ..., "deeplab": ...})`.

    fusion_stride=2 runs the gate, head and residual on the branch logits
    resized to half resolution and resizes the result back.  Train mode
    applies the JAX package's regularisers: element-wise dropout after the
    first two fusion-head layers (`fusion_dropout`), stochastic depth in
    both encoders (`drop_connect_rate`) and the ASPP's dropout
    (`aspp_dropout`), drawn from `generator`.  (The reference's fusion head
    uses channel-wise `Dropout2d`; the JAX package drops elements, and the
    port follows it.  The `Dropout2d` modules stay only for the state-dict
    layout and are never called.)"""

    def __init__(self, num_classes: int = 3, fusion_stride: int = 1,
                 encoder_names: Tuple[str, str] = ("efficientnet-b5",
                                                   "efficientnet-b4"),
                 packed_decoder: bool = True, packed_fusion: bool = False,
                 fusion_dropout: Tuple[float, float] = (0.2, 0.15),
                 drop_connect_rate: float = 0.2, aspp_dropout: float = 0.5,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if fusion_stride < 1:
            raise ValueError(f"fusion_stride must be >= 1, got {fusion_stride}")
        self.unetpp = UNetPlusPlus(num_classes, encoder_names[0],
                                   drop_connect_rate=drop_connect_rate, dtype=dtype)
        self.deeplab = DeepLabV3Plus(num_classes, encoder_names[1],
                                     drop_connect_rate=drop_connect_rate,
                                     aspp_dropout=aspp_dropout, dtype=dtype)
        fc = 2 * num_classes
        self.attention_gate = nn.Sequential(
            nn.Conv2d(fc, fc // 2, 3, padding=1, bias=False),
            nn.BatchNorm2d(fc // 2), nn.GELU(),
            nn.Conv2d(fc // 2, fc, 1, bias=False),
            nn.BatchNorm2d(fc), nn.Sigmoid())
        self.fusion_head = nn.Sequential(
            nn.Conv2d(fc, 256, 3, padding=1, bias=False), nn.BatchNorm2d(256),
            nn.ReLU(), nn.Dropout2d(fusion_dropout[0]),
            row_split(nn.Conv2d(256, 128, 3, padding=1, bias=False)), nn.BatchNorm2d(128),
            nn.ReLU(), nn.Dropout2d(fusion_dropout[1]),
            nn.Conv2d(128, 64, 3, padding=1, bias=False), nn.BatchNorm2d(64),
            nn.ReLU(), nn.Conv2d(64, num_classes, 1))
        self.fusion_residual = nn.Conv2d(fc, num_classes, 1)
        self.fusion_stride = fusion_stride
        self.fusion_dropout = tuple(fusion_dropout)
        self.drop_connect_rate = drop_connect_rate
        self.aspp_dropout = aspp_dropout
        # TPU layout options of the JAX package: same math, nothing to do
        self.packed_decoder = packed_decoder
        self.packed_fusion = packed_fusion
        self.dtype = dtype

    def forward(self, x_nhwc: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, Dict]:
        if self.training and max(*self.fusion_dropout, self.drop_connect_rate,
                                 self.aspp_dropout) > 0.0:
            need_generator(generator, "EnhancedUNet")
        x = x_nhwc.permute(0, 3, 1, 2)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        out_main = self.unetpp(x, generator)
        out_aux = self.deeplab(x, generator)
        with span("model.fusion", device=x.device):
            fused = torch.cat([out_main, out_aux], dim=1)
            full_hw = fused.shape[2:]
            s = self.fusion_stride
            if s > 1:
                fused = resize_bilinear_nchw(fused, (full_hw[0] // s, full_hw[1] // s))

            dt = self.dtype
            gate = self.attention_gate
            a = batch_norm(conv(fused, gate[0], dt), gate[1])
            a = F.gelu(a)                      # exact erf form
            a = batch_norm(conv(a, gate[3], dt), gate[4])
            gated = fused * torch.sigmoid(a.float())

            head = self.fusion_head
            y = gated.to(dt)
            for k, (c_i, b_i) in enumerate(((0, 1), (4, 5), (8, 9))):
                y = conv_bn_act(y, head[c_i], head[b_i], True, dt)
                if self.training and k < 2:
                    y = dropout(y, self.fusion_dropout[k], generator)
            logits = conv(y, head[11], dt).float()
            logits = logits + conv(gated, self.fusion_residual, torch.float32)
            if s > 1:
                logits = resize_bilinear_nchw(logits, full_hw)

        def nhwc(t):
            return t.permute(0, 2, 3, 1)

        return nhwc(logits), {"unetpp": nhwc(out_main), "deeplab": nhwc(out_aux)}
