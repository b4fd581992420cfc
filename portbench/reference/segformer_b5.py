"""Plain fp32 reference of SegFormer-B5 (Xie et al., NeurIPS 2021,
arXiv:2105.15203): the Mix Transformer encoder MiT-B5 and the all-MLP
decode head, with the equations and the state-dict names of `transformers`'
`SegformerForSemanticSegmentation` (`modeling_segformer.py`, 4.57) and the
sizes of `nvidia/segformer-b5-finetuned-ade-640-640`'s `config.json`.

Written from those equations in plain torch on NCHW maps and [N, L, C]
token sequences: nothing here imports the program under test or
`transformers`.  Attention is `matmul`, `softmax`, `matmul`, so that
`torch.utils.flop_counter` counts it.  The convs are `common.Conv2d`, the
linears and the two attention products are this file's `Linear` and
`SelfAttention`, whose operands the control rounds through fp8 (their
`precision`, set with `set_token_precision`).

The input is an RGB image in [0, 1], as the serving path hands every model
its enhanced tiles; the forward normalises it first with ImageNet's mean
and standard deviation a channel, as `SegformerImageProcessor` does before
a checkpoint sees an image.

Departures from the published description: the classifier has the
configuration's `num_classes` (3: background, live, dead) in place of
ADE20K's 150 labels.  The logits are resized bilinearly (half-pixel) from
stride 4 to the input, as `SegformerForSemanticSegmentation` resizes them
for its loss.  Dropout and drop path are train-only: this reference runs
in eval mode.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.common import Conv2d, fp8_round

EPS = 1e-5            # nn.LayerNorm's default; the config's layer_norm_eps is read by no module
MEAN = (0.485, 0.456, 0.406)    # SegformerImageProcessor's image_mean and image_std
STD = (0.229, 0.224, 0.225)


class Linear(nn.Linear):
    """`nn.Linear` whose input and weight are rounded through fp8 when
    `precision` is "fp8" (the control)."""

    precision = "fp32"

    def forward(self, x):
        if self.precision == "fp8":
            return F.linear(fp8_round(x), fp8_round(self.weight), self.bias)
        return super().forward(x)


def tokens(x: torch.Tensor) -> torch.Tensor:
    """[N, C, H, W] -> [N, H*W, C]."""
    return x.flatten(2).transpose(1, 2)


def grid(t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[N, H*W, C] -> [N, C, H, W]."""
    return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], h, w)


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, stride: int, cin: int, c: int):
        super().__init__()
        self.proj = Conv2d(cin, c, patch, stride, patch // 2)
        self.layer_norm = nn.LayerNorm(c, eps=EPS)

    def forward(self, x):
        y = self.proj(x)
        return self.layer_norm(tokens(y)), y.shape[2], y.shape[3]


class SelfAttention(nn.Module):
    """Efficient self-attention: q from every token, k and v from the
    tokens reduced by a strided conv (ratio r > 1) and a LayerNorm."""

    precision = "fp32"

    def __init__(self, c: int, heads: int, r: int):
        super().__init__()
        self.heads, self.d = heads, c // heads
        self.query, self.key, self.value = Linear(c, c), Linear(c, c), Linear(c, c)
        self.r = r
        if r > 1:
            self.sr = Conv2d(c, c, r, r)
            self.layer_norm = nn.LayerNorm(c, eps=EPS)

    def forward(self, x, h, w):
        n, length, c = x.shape

        def heads(t):
            return t.reshape(n, -1, self.heads, self.d).transpose(1, 2)

        q = heads(self.query(x))
        kv = x
        if self.r > 1:
            kv = self.layer_norm(tokens(self.sr(grid(x, h, w))))
        k, v = heads(self.key(kv)), heads(self.value(kv))
        rnd = fp8_round if self.precision == "fp8" else (lambda t: t)
        scores = torch.matmul(rnd(q), rnd(k).transpose(-1, -2)) / math.sqrt(self.d)
        probs = torch.softmax(scores, dim=-1)
        out = torch.matmul(rnd(probs), rnd(v))
        return out.transpose(1, 2).reshape(n, length, c)


class AttentionOutput(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.dense = Linear(c, c)


class AttentionBlock(nn.Module):
    def __init__(self, c: int, heads: int, r: int):
        super().__init__()
        self.self = SelfAttention(c, heads, r)
        self.output = AttentionOutput(c)

    def forward(self, x, h, w):
        return self.output.dense(self.self(x, h, w))


class DWConv(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.dwconv = Conv2d(c, c, 3, 1, 1, groups=c)

    def forward(self, x, h, w):
        return tokens(self.dwconv(grid(x, h, w)))


class MixFFN(nn.Module):
    """dense1 (C -> 4C), the 3x3 depthwise conv with bias, exact GELU, dense2."""

    def __init__(self, c: int, hidden: int):
        super().__init__()
        self.dense1 = Linear(c, hidden)
        self.dwconv = DWConv(hidden)
        self.dense2 = Linear(hidden, c)

    def forward(self, x, h, w):
        return self.dense2(F.gelu(self.dwconv(self.dense1(x), h, w)))


class Block(nn.Module):
    """x + Attn(LN1(x)), then x + MixFFN(LN2(x))."""

    def __init__(self, c: int, heads: int, r: int, ratio: int):
        super().__init__()
        self.layer_norm_1 = nn.LayerNorm(c, eps=EPS)
        self.attention = AttentionBlock(c, heads, r)
        self.layer_norm_2 = nn.LayerNorm(c, eps=EPS)
        self.mlp = MixFFN(c, c * ratio)

    def forward(self, x, h, w):
        x = x + self.attention(self.layer_norm_1(x), h, w)
        return x + self.mlp(self.layer_norm_2(x), h, w)


class MixTransformer(nn.Module):
    def __init__(self, hidden: Sequence[int], depths: Sequence[int], heads: Sequence[int],
                 ratios: Sequence[int], patches: Sequence[int], strides: Sequence[int],
                 mlp: Sequence[int], cin: int = 3):
        super().__init__()
        self.patch_embeddings = nn.ModuleList(
            PatchEmbed(patches[i], strides[i], cin if i == 0 else hidden[i - 1], hidden[i])
            for i in range(len(hidden)))
        self.block = nn.ModuleList(
            nn.ModuleList(Block(hidden[i], heads[i], ratios[i], mlp[i]) for _ in range(depths[i]))
            for i in range(len(hidden)))
        self.layer_norm = nn.ModuleList(nn.LayerNorm(c, eps=EPS) for c in hidden)

    def forward(self, x):
        out = []
        for embed, blocks, norm in zip(self.patch_embeddings, self.block, self.layer_norm):
            t, h, w = embed(x)
            for blk in blocks:
                t = blk(t, h, w)
            x = grid(norm(t), h, w)
            out.append(x)
        return out


class Body(nn.Module):
    def __init__(self, **kw):
        super().__init__()
        self.encoder = MixTransformer(**kw)


class MLPProj(nn.Module):
    def __init__(self, cin: int, c: int):
        super().__init__()
        self.proj = Linear(cin, c)


class AllMLPHead(nn.Module):
    """linear_c[i] to the decoder width, bilinear resize to stride 4,
    concatenation c4, c3, c2, c1, linear_fuse (1x1, no bias), BN, ReLU,
    classifier."""

    def __init__(self, hidden: Sequence[int], width: int, classes: int):
        super().__init__()
        self.linear_c = nn.ModuleList(MLPProj(c, width) for c in hidden)
        self.linear_fuse = Conv2d(width * len(hidden), width, 1, bias=False)
        self.batch_norm = nn.BatchNorm2d(width)
        self.classifier = Conv2d(width, classes, 1)

    def forward(self, feats):
        size = feats[0].shape[2:]
        maps = []
        for f, mlp in zip(feats, self.linear_c):
            y = grid(mlp.proj(tokens(f)), f.shape[2], f.shape[3])
            maps.append(F.interpolate(y, size=size, mode="bilinear", align_corners=False))
        y = F.relu(self.batch_norm(self.linear_fuse(torch.cat(maps[::-1], dim=1))))
        return self.classifier(y)


class SegFormerRef(nn.Module):
    def __init__(self, classes: int, hidden=(64, 128, 320, 512), depths=(3, 6, 40, 3),
                 heads=(1, 2, 5, 8), ratios=(8, 4, 2, 1), patches=(7, 3, 3, 3),
                 strides=(4, 2, 2, 2), mlp=(4, 4, 4, 4), width: int = 768):
        super().__init__()
        self.segformer = Body(hidden=hidden, depths=depths, heads=heads, ratios=ratios,
                              patches=patches, strides=strides, mlp=mlp)
        self.decode_head = AllMLPHead(hidden, width, classes)

    def forward(self, x):
        mean = torch.tensor(MEAN, device=x.device).view(1, 3, 1, 1)
        std = torch.tensor(STD, device=x.device).view(1, 3, 1, 1)
        logits = self.decode_head(self.segformer.encoder((x - mean) / std))
        return F.interpolate(logits, size=x.shape[2:], mode="bilinear",
                             align_corners=False), {}


def set_token_precision(model: nn.Module, precision: str) -> nn.Module:
    """The linears' and attention products' precision ("fp32" or "fp8");
    `common.set_precision` sets the convs'."""
    if precision not in ("fp32", "fp8"):
        raise ValueError(f"unknown precision {precision}")
    for m in model.modules():
        if isinstance(m, (Linear, SelfAttention)):
            m.precision = precision
    return model


def build(config: dict) -> nn.Module:
    """The reference model of a configuration file: its published sizes
    (`model_kwargs`, under `transformers`' names) and `num_classes`."""
    kw = config["model_kwargs"]
    return SegFormerRef(
        config.get("num_classes", 3), tuple(kw["hidden_sizes"]), tuple(kw["depths"]),
        tuple(kw["num_attention_heads"]), tuple(kw["sr_ratios"]), tuple(kw["patch_sizes"]),
        tuple(kw["strides"]), tuple(kw["mlp_ratios"]), int(kw["decoder_hidden_size"]))
