"""SegFormer (Xie et al., NeurIPS 2021, arXiv:2105.15203): the Mix
Transformer encoder and the all-MLP decode head, as `transformers`'
`SegformerForSemanticSegmentation` computes them, with its state-dict names
(`segformer.encoder.*`, `decode_head.*`), so its checkpoints load without
renaming.  The defaults are MiT-B5's (`nvidia/segformer-b5-finetuned-ade-
640-640`): hidden sizes 64-128-320-512, depths 3-6-40-3, heads 1-2-5-8
(head size 64), spatial reductions 8-4-2-1, patches 7-3-3-3 at strides
4-2-2-2, Mix-FFN ratio 4, decoder width 768.

- Patch embedding: a conv (kernel p, stride s, padding p // 2), then
  LayerNorm.
- A block: `x += Attn(LN1(x))`, `x += MixFFN(LN2(x))`.  Attention: separate
  q, k and v linears; with a reduction r > 1 the keys and values come from
  `LN(Conv2d(C, C, r, stride r)(x))`; `softmax(q k^T / sqrt(64)) v` through
  `efficient_attention`, then the output linear.  Mix-FFN: C -> 4C linear, a
  3x3 depthwise conv with bias, exact-erf GELU, 4C -> C linear.
- A LayerNorm after each stage; every LayerNorm at eps 1e-5 (`transformers`
  reads no other).
- The head: each stage's linear to the decoder width, resized bilinearly
  (half-pixel) to stride 4, concatenated c4, c3, c2, c1, a 1x1 conv without
  bias, BN, ReLU and the classifier; its stride-4 logits resized bilinearly
  to the input, as `SegformerForSemanticSegmentation` resizes them.

Called as every model of the port: `model(x_nhwc, generator=None) ->
(logits_nhwc_f32, {})`, x an RGB image in [0, 1] as the Evaluator hands
every model its enhanced tiles.  The forward first normalises it as
`SegformerImageProcessor` does before a checkpoint sees it: ImageNet's mean
and standard deviation a channel (`IMAGE_MEAN`, `IMAGE_STD`), in fp32.
Parameters are fp32; a forward computes in `dtype` (bf16 on the card), the
weights cast once and kept on their layers without autograd (`_cast`), on
each call with it.  The tokens
[N, H, W, C] are the activations' NHWC memory: the linears and LayerNorms
act on the last dim, and the convs see the same memory as a channels_last
NCHW view, so no layout copy is made.  In eval mode the Mix-FFN's depthwise,
bias and GELU run as one kernel (`ops.kernels.depthwise.dw3x3_bias_gelu_nhwc`;
on the CPU its plain version), its weights laid out once and kept on the
module (`MixFFNDWConv.fold`); train mode runs stock ops.  Dropout and drop
path are train-only and not modelled: the port serves this model and does
not train it.

Under a profiler a forward records five spans (`utils.profiler`):
`model.segformer.stage1` ... `stage4` (each stage's patch embedding, blocks
and final LayerNorm) and `model.segformer.head`.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from enhanced_unet_tpu_torch.models.blocks import (
    batch_norm,
    cached_weights,
    conv,
    refuse_autograd,
)
from enhanced_unet_tpu_torch.ops.kernels.depthwise import (
    DwFolded,
    dw3x3_bias_gelu_nhwc,
    fold_dw_bias,
)
from enhanced_unet_tpu_torch.ops.resize import resize_bilinear_nchw
from enhanced_unet_tpu_torch.utils.profiler import span

LN_EPS = 1e-5
# SegformerImageProcessor's `image_mean` and `image_std` (ImageNet's), on [0, 1]
IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)


def efficient_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v of [N, heads, L, d] views (last dim
    contiguous), [N, heads, Lq, d] out: every attention of the model goes
    through this one call."""
    return F.scaled_dot_product_attention(q, k, v)


def _cast(layer: nn.Module, dtype: torch.dtype) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """`layer`'s weight and bias in `dtype`.  Without autograd they are cast
    once and kept on the layer, keyed by each tensor's `(data_ptr,
    _version)` and the dtype, and cast again when either is replaced or
    edited (`load_state_dict`, `.to()`, an in-place edit): a B5 forward
    would otherwise launch about 1,150 casts, more than half its kernels.
    With autograd on (train mode) they are cast on each call, so gradients
    reach the parameters."""
    w, b = layer.weight, layer.bias
    if torch.is_grad_enabled():
        return w.to(dtype), None if b is None else b.to(dtype)
    key = (w.data_ptr(), w._version, dtype) + (() if b is None else (b.data_ptr(), b._version))
    cached = layer.__dict__.get("_cast")
    if cached is None or cached[0] != key:
        with torch.inference_mode(False), torch.no_grad():
            cached = (key, (w.to(dtype), None if b is None else b.to(dtype)))
        layer.__dict__["_cast"] = cached
    return cached[1]


def _linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), *_cast(layer, dtype))


def _conv(x: torch.Tensor, layer: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    w, b = _cast(layer, dtype)
    return F.conv2d(x.to(dtype), w, b, layer.stride, layer.padding, layer.dilation, layer.groups)


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    return F.layer_norm(x.to(dtype), ln.normalized_shape, *_cast(ln, dtype), ln.eps)


def _nchw(t: torch.Tensor) -> torch.Tensor:
    """NHWC tokens as an NCHW view (channels_last memory)."""
    return t.permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    """An NCHW map as NHWC tokens: a view of channels_last memory, else a
    copy."""
    return t.permute(0, 2, 3, 1).contiguous()


class OverlapPatchEmbeddings(nn.Module):
    def __init__(self, patch_size: int, stride: int, num_channels: int, hidden_size: int):
        super().__init__()
        self.proj = nn.Conv2d(num_channels, hidden_size, patch_size, stride, patch_size // 2)
        self.layer_norm = nn.LayerNorm(hidden_size, eps=LN_EPS)

    def forward(self, x_nchw: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return _layer_norm(_nhwc(_conv(x_nchw, self.proj, dtype)), self.layer_norm, dtype)


class EfficientSelfAttention(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, sr_ratio: int):
        super().__init__()
        if hidden_size % num_heads:
            raise ValueError(f"hidden size {hidden_size} is not a multiple of {num_heads} heads")
        self.num_heads = num_heads
        self.query = nn.Linear(hidden_size, hidden_size)
        self.key = nn.Linear(hidden_size, hidden_size)
        self.value = nn.Linear(hidden_size, hidden_size)
        self.sr_ratio = sr_ratio
        if sr_ratio > 1:
            self.sr = nn.Conv2d(hidden_size, hidden_size, sr_ratio, sr_ratio)
            self.layer_norm = nn.LayerNorm(hidden_size, eps=LN_EPS)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        n, h, w, c = x.shape
        heads = self.num_heads

        def split(t):                   # [N, L, C] -> [N, heads, L, C / heads], a view
            return t.view(n, -1, heads, c // heads).transpose(1, 2)

        q = split(_linear(x, self.query, dtype))
        kv = x
        if self.sr_ratio > 1:
            kv = _layer_norm(_nhwc(_conv(_nchw(x), self.sr, dtype)), self.layer_norm, dtype)
        out = efficient_attention(q, split(_linear(kv, self.key, dtype)),
                                  split(_linear(kv, self.value, dtype)))
        return out.transpose(1, 2).reshape(n, h, w, c)


class SelfOutput(nn.Module):
    def __init__(self, hidden_size: int):
        super().__init__()
        self.dense = nn.Linear(hidden_size, hidden_size)


class Attention(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, sr_ratio: int):
        super().__init__()
        self.self = EfficientSelfAttention(hidden_size, num_heads, sr_ratio)
        self.output = SelfOutput(hidden_size)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return _linear(self.self(x, dtype), self.output.dense, dtype)


class MixFFNDWConv(nn.Module):
    """The Mix-FFN's 3x3 depthwise conv with bias (`dwconv.dwconv`), GELU
    fused in eval mode."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, 1, 1, bias=True, groups=dim)
        self.dtype = dtype

    def fold(self) -> DwFolded:
        """The kernel's weights ([3, 3, C] in the compute dtype, the bias as
        the fp32 shift) on the parameters' device, kept on the module and
        laid out again when the conv's weight or bias is replaced or edited;
        each laying out counts `kernels.mixffn_fold` (`utils.profiler`)."""
        tensors = [self.dwconv.weight, self.dwconv.bias]
        return cached_weights(self, "_folded", tensors, "kernels.mixffn_fold",
                              lambda: fold_dw_bias(tensors[0], tensors[1], self.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """GELU(dwconv(x)) of NHWC tokens, NHWC out."""
        if self.training:
            return F.gelu(_nhwc(conv(_nchw(x), self.dwconv, self.dtype)))
        refuse_autograd("the Mix-FFN's depthwise conv", self.parameters())
        return _nhwc(dw3x3_bias_gelu_nhwc(_nchw(x.to(self.dtype)), self.fold()))


class MixFFN(nn.Module):
    def __init__(self, hidden_size: int, mlp_size: int, dtype: torch.dtype):
        super().__init__()
        self.dense1 = nn.Linear(hidden_size, mlp_size)
        self.dwconv = MixFFNDWConv(mlp_size, dtype)
        self.dense2 = nn.Linear(mlp_size, hidden_size)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return _linear(self.dwconv(_linear(x, self.dense1, dtype)), self.dense2, dtype)


class Layer(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, sr_ratio: int, mlp_ratio: int,
                 dtype: torch.dtype):
        super().__init__()
        self.layer_norm_1 = nn.LayerNorm(hidden_size, eps=LN_EPS)
        self.attention = Attention(hidden_size, num_heads, sr_ratio)
        self.layer_norm_2 = nn.LayerNorm(hidden_size, eps=LN_EPS)
        self.mlp = MixFFN(hidden_size, hidden_size * mlp_ratio, dtype)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = x + self.attention(_layer_norm(x, self.layer_norm_1, dtype), dtype)
        return x + self.mlp(_layer_norm(x, self.layer_norm_2, dtype), dtype)


class Encoder(nn.Module):
    def __init__(self, num_channels: int, hidden_sizes: Sequence[int], depths: Sequence[int],
                 num_heads: Sequence[int], sr_ratios: Sequence[int],
                 patch_sizes: Sequence[int], strides: Sequence[int],
                 mlp_ratios: Sequence[int], dtype: torch.dtype):
        super().__init__()
        ins = [num_channels, *hidden_sizes[:-1]]
        self.patch_embeddings = nn.ModuleList(
            OverlapPatchEmbeddings(p, s, cin, c)
            for p, s, cin, c in zip(patch_sizes, strides, ins, hidden_sizes))
        self.block = nn.ModuleList(
            nn.ModuleList(Layer(c, heads, sr, ratio, dtype) for _ in range(depth))
            for c, depth, heads, sr, ratio in zip(hidden_sizes, depths, num_heads, sr_ratios,
                                                  mlp_ratios))
        self.layer_norm = nn.ModuleList(nn.LayerNorm(c, eps=LN_EPS) for c in hidden_sizes)

    def forward(self, x_nchw: torch.Tensor, dtype: torch.dtype) -> list:
        """The four stages' outputs as NHWC tokens."""
        feats = []
        x = x_nchw
        for i, (embed, blocks, norm) in enumerate(zip(self.patch_embeddings, self.block,
                                                      self.layer_norm)):
            with span(f"model.segformer.stage{i + 1}", device=x.device):
                t = embed(x, dtype)
                for blk in blocks:
                    t = blk(t, dtype)
                t = _layer_norm(t, norm, dtype)
            feats.append(t)
            x = _nchw(t)
        return feats


class SegformerModel(nn.Module):
    def __init__(self, **kw):
        super().__init__()
        self.encoder = Encoder(**kw)


class MLP(nn.Module):
    def __init__(self, input_dim: int, decoder_hidden_size: int):
        super().__init__()
        self.proj = nn.Linear(input_dim, decoder_hidden_size)


class DecodeHead(nn.Module):
    def __init__(self, hidden_sizes: Sequence[int], decoder_hidden_size: int,
                 num_classes: int):
        super().__init__()
        self.linear_c = nn.ModuleList(MLP(c, decoder_hidden_size) for c in hidden_sizes)
        self.linear_fuse = nn.Conv2d(decoder_hidden_size * len(hidden_sizes),
                                     decoder_hidden_size, 1, bias=False)
        self.batch_norm = nn.BatchNorm2d(decoder_hidden_size)
        self.classifier = nn.Conv2d(decoder_hidden_size, num_classes, 1)

    def forward(self, feats: list, dtype: torch.dtype) -> torch.Tensor:
        """Stride-4 logits [N, classes, H/4, W/4] (NCHW view of NHWC
        memory) in `dtype`."""
        size = tuple(feats[0].shape[1:3])
        maps = []
        for t, mlp in zip(feats, self.linear_c):
            m = _nchw(_linear(t, mlp.proj, dtype))
            if tuple(m.shape[2:]) != size:    # at its own size the resize is the identity
                m = resize_bilinear_nchw(m, size)
            maps.append(_nhwc(m))
        fused = torch.cat(maps[::-1], dim=-1)
        del maps
        y = F.linear(fused, _cast(self.linear_fuse, dtype)[0][:, :, 0, 0])
        del fused
        y = F.relu_(batch_norm(_nchw(y), self.batch_norm))
        return _conv(y, self.classifier, dtype)


class SegFormer(nn.Module):
    """SegFormer with MiT-B5's sizes by default (see the module's
    docstring); `num_classes` replaces the published 150 ADE20K labels."""

    def __init__(self, num_classes: int = 3, hidden_sizes: Sequence[int] = (64, 128, 320, 512),
                 depths: Sequence[int] = (3, 6, 40, 3),
                 num_attention_heads: Sequence[int] = (1, 2, 5, 8),
                 sr_ratios: Sequence[int] = (8, 4, 2, 1),
                 patch_sizes: Sequence[int] = (7, 3, 3, 3), strides: Sequence[int] = (4, 2, 2, 2),
                 mlp_ratios: Sequence[int] = (4, 4, 4, 4), decoder_hidden_size: int = 768,
                 num_channels: int = 3, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.segformer = SegformerModel(
            num_channels=num_channels, hidden_sizes=tuple(hidden_sizes), depths=tuple(depths),
            num_heads=tuple(num_attention_heads), sr_ratios=tuple(sr_ratios),
            patch_sizes=tuple(patch_sizes), strides=tuple(strides),
            mlp_ratios=tuple(mlp_ratios), dtype=dtype)
        self.decode_head = DecodeHead(hidden_sizes, decoder_hidden_size, num_classes)
        self.dtype = dtype
        # not in the state dict: a checkpoint's names stay transformers' own
        self.register_buffer("image_mean", torch.tensor(IMAGE_MEAN), persistent=False)
        self.register_buffer("image_std", torch.tensor(IMAGE_STD), persistent=False)

    def forward(self, x_nhwc: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, Dict]:
        dt = self.dtype
        x = ((x_nhwc.float() - self.image_mean) / self.image_std).to(dt).permute(0, 3, 1, 2)
        if x.is_cuda:                   # channels_last where x_nhwc is contiguous
            x = x.contiguous(memory_format=torch.channels_last)
        feats = self.segformer.encoder(x, dt)
        with span("model.segformer.head", device=x.device):
            logits = self.decode_head(feats, dt).float()
            logits = resize_bilinear_nchw(logits, tuple(x_nhwc.shape[1:3]))
        return logits.permute(0, 2, 3, 1), {}
