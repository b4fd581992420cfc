"""Building blocks of the flagship, ported from
`enhanced_unet_tpu/models/blocks.py` (ConvBNAct, DoubleConv, SCSEBlock,
SeparableConvBNAct, ASPP).

NCHW modules whose parameter names follow the reference state dict
(segmentation_models_pytorch's `Conv2dReLU`, `SCSEModule`,
`SeparableConv2d`, `ASPP`), so `enhanced_unet_tpu.convert.torch_import`
reads a port state dict as it reads a reference checkpoint.  Parameters are
fp32; each module computes in its `dtype`, cast where flax's `dtype=` casts.
In eval mode BatchNorm uses its running statistics and dropout is off; in
train mode BatchNorm follows flax (see `batch_norm`) and dropout draws from an
explicit `torch.Generator`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from enhanced_unet_tpu_torch.ops.kernels.conv_fused import (
    PackedConv3x3,
    fold_bn_params,
    fused_conv3x3_bn_relu_packed,
    pack_conv3x3,
)


def conv(x: torch.Tensor, layer: nn.Conv2d, dtype: torch.dtype,
         padding=None) -> torch.Tensor:
    """`layer` applied in `dtype` (input, kernel and bias cast, as flax's
    `nn.Conv(dtype=...)` does).  `padding` overrides the layer's own."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.conv2d(x.to(dtype), layer.weight.to(dtype), bias, layer.stride,
                    layer.padding if padding is None else padding,
                    layer.dilation, layer.groups)


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """BatchNorm in x's dtype.  Eval mode: the running statistics.  Train
    mode: flax's `nn.BatchNorm`, not torch's.  The batch statistics are
    reduced in fp32 (also for a bf16 x), x is normalised with the biased
    variance, and the running statistics move as `m * running + (1 - m) *
    batch` with flax's momentum m = 1 - `bn.momentum` and the biased variance
    (torch would update with the unbiased one)."""
    if not bn.training:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, False, 0.0, bn.eps)
    # momentum 1 writes the batch mean and unbiased variance into the zeros
    mean = torch.zeros_like(bn.running_mean)
    var = torch.zeros_like(bn.running_var)
    y = F.batch_norm(x, mean, var, bn.weight, bn.bias, True, 1.0, bn.eps)
    n = x.numel() // x.shape[1]
    m = 1.0 - bn.momentum
    with torch.no_grad():
        bn.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
        bn.running_var.mul_(m).add_(var, alpha=(1.0 - m) * (n - 1) / n)
    return y


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's `nn.Dropout` in train mode: each element kept with probability
    1 - rate (a uniform draw below it) and scaled by 1 / (1 - rate)."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    # the draws in x's memory layout, so the select below runs on matching
    # strides (a channels_last x against an NCHW mask takes a slow strided path)
    mask = torch.empty_like(x, dtype=torch.float32).uniform_(
        generator=need_generator(generator, "dropout")) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def need_generator(generator: Optional[torch.Generator],
                   what: str) -> torch.Generator:
    """`generator`, or an error: random draws in train mode come from an
    explicit `torch.Generator`, never from the global one."""
    if generator is None:
        raise ValueError(f"{what} in train mode needs a torch.Generator "
                         "(pass generator=...)")
    return generator


def refuse_autograd(block: str, params) -> None:
    """Raise when autograd would record a fused kernel's call (grad mode on
    and a weight of the block requiring grad).  The kernels and their plain
    versions compute from weights folded or packed under `no_grad`, so the
    graph would skip those weights; the kernels have no backward."""
    if torch.is_grad_enabled() and any(p.requires_grad for p in params):
        raise RuntimeError(
            f"{block}: the fused inference kernel has no backward; run eval-mode "
            "forwards under torch.no_grad()/torch.inference_mode(), or use train mode")


def packed_conv3x3(layer: nn.Conv2d, bn: nn.BatchNorm2d, dtype: torch.dtype,
                   device: torch.device) -> PackedConv3x3:
    """The fused kernel's weights for `layer` + `bn` (BN folded, cast,
    permuted), packed once and kept on `layer`.  They are packed again when
    the conv weight or bias or a BN tensor is replaced or edited in place
    (`load_state_dict`, `.to()`, `weight.mul_`: a new `data_ptr` or
    `_version`), or for another dtype or device."""
    tensors = [layer.weight, layer.bias, bn.weight, bn.bias, bn.running_mean,
               bn.running_var]
    key = (tuple(None if t is None else (t.data_ptr(), t._version) for t in tensors),
           bn.eps, dtype, device)
    cached = layer.__dict__.get("_packed_conv3x3")
    if cached is not None and cached[0] == key:
        return cached[1]
    scale, shift = fold_bn_params(bn.weight, bn.bias, bn.running_mean,
                                  bn.running_var, bn.eps, layer.bias)
    packed = pack_conv3x3(layer.weight.permute(2, 3, 1, 0), scale, shift, dtype,
                          device)
    layer.__dict__["_packed_conv3x3"] = (key, packed)
    return packed


def conv_bn_act(x: torch.Tensor, layer: nn.Conv2d, bn: nn.BatchNorm2d,
                relu: bool, dtype: torch.dtype) -> torch.Tensor:
    """Conv -> BN -> optional ReLU.  In eval mode a 3x3, stride-1,
    undilated, ungrouped conv goes through the fused conv3x3+BN+ReLU kernel
    with its weights packed once (its plain version on the CPU), and raises
    when autograd would record it; train mode (batch statistics, which a
    folded BN cannot give) and any other conv run as plain PyTorch."""
    if (not bn.training and layer.kernel_size == (3, 3) and layer.stride == (1, 1)
            and layer.dilation == (1, 1) and layer.groups == 1):
        refuse_autograd(f"3x3 ConvBNAct {layer.in_channels}->{layer.out_channels}",
                        (layer.weight, bn.weight, bn.bias))
        xh = x.to(dtype).permute(0, 2, 3, 1).contiguous()
        y = fused_conv3x3_bn_relu_packed(
            xh, packed_conv3x3(layer, bn, dtype, xh.device), relu=relu)
        return y.permute(0, 3, 1, 2)
    y = batch_norm(conv(x, layer, dtype), bn)
    return torch.relu(y) if relu else y


class ConvBNAct(nn.Sequential):
    """Conv2d (no bias: a bias before BN is dead) -> BatchNorm -> ReLU or
    no activation.  State-dict layout of smp's `Conv2dReLU` (`0` conv,
    `1` BN).  Padding is symmetric `k // 2`, which equals TF SAME at
    stride 1."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 act: Optional[str] = "relu", eps: float = 1e-5,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(
            nn.Conv2d(cin, cout, kernel_size, padding=kernel_size // 2,
                      bias=False),
            nn.BatchNorm2d(cout, eps=eps),
        )
        if act not in ("relu", None):
            raise ValueError(f"unsupported activation {act}")
        self.act = act
        self.dtype = dtype

    def forward(self, x):
        return conv_bn_act(x, self[0], self[1], self.act == "relu", self.dtype)


class DoubleConv(nn.Module):
    """Two 3x3 ConvBNAct blocks (`conv1`, `conv2`, as in smp's
    DecoderBlock)."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv1 = ConvBNAct(cin, cout, dtype=dtype)
        self.conv2 = ConvBNAct(cout, cout, dtype=dtype)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class SCSEBlock(nn.Module):
    """Concurrent spatial and channel squeeze-excitation (smp SCSEModule:
    `cSE.1`, `cSE.3`, `sSE.0`)."""

    def __init__(self, c: int, reduction: int = 16,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        mid = max(c // reduction, 1)
        self.cSE = nn.Sequential(nn.AdaptiveAvgPool2d(1), nn.Conv2d(c, mid, 1),
                                 nn.ReLU(), nn.Conv2d(mid, c, 1), nn.Sigmoid())
        self.sSE = nn.Sequential(nn.Conv2d(c, 1, 1), nn.Sigmoid())
        self.dtype = dtype

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        s = torch.relu(conv(s, self.cSE[1], self.dtype))
        s = conv(s, self.cSE[3], self.dtype)
        cse = x * torch.sigmoid(s)
        t = conv(x, self.sSE[0], self.dtype)
        return cse + x * torch.sigmoid(t)


class Attention(nn.Module):
    """smp's `Attention("scse")` wrapper: the block lives at `.attention`."""

    def __init__(self, c: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.attention = SCSEBlock(c, dtype=dtype)

    def forward(self, x):
        return self.attention(x)


class SeparableConv2d(nn.Sequential):
    """Depthwise (optionally dilated) 3x3 then pointwise 1x1, both without
    bias (smp SeparableConv2d: `0` depthwise, `1` pointwise)."""

    def __init__(self, cin: int, cout: int, dilation: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(
            nn.Conv2d(cin, cin, 3, padding=dilation, dilation=dilation,
                      groups=cin, bias=False),
            nn.Conv2d(cin, cout, 1, bias=False),
        )
        self.dtype = dtype

    def forward(self, x):
        return conv(conv(x, self[0], self.dtype), self[1], self.dtype)


class SeparableConvBNAct(nn.Sequential):
    """SeparableConv2d -> BN -> ReLU (smp ASPPSeparableConv / decoder
    block2: `0.0` depthwise, `0.1` pointwise, `1` BN)."""

    def __init__(self, cin: int, cout: int, dilation: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(SeparableConv2d(cin, cout, dilation, dtype),
                         nn.BatchNorm2d(cout))

    def forward(self, x):
        return torch.relu(batch_norm(self[0](x), self[1]))


class ASPPPooling(nn.Sequential):
    """Image-level branch: global mean -> 1x1 conv -> BN -> ReLU, broadcast
    back to the input size (smp ASPPPooling: `1` conv, `2` BN)."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__(nn.AdaptiveAvgPool2d(1),
                         nn.Conv2d(cin, cout, 1, bias=False),
                         nn.BatchNorm2d(cout), nn.ReLU())
        self.dtype = dtype

    def forward(self, x):
        g = x.mean(dim=(2, 3), keepdim=True)
        g = torch.relu(batch_norm(conv(g, self[1], self.dtype), self[2]))
        return g.expand(-1, -1, x.shape[2], x.shape[3]).to(x.dtype)


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling as in smp's DeepLabV3+ (separable):
    a 1x1 branch, three separable dilated 3x3 branches and a pooled branch,
    fused by a 1x1 projection and an element-wise dropout (train mode)."""

    def __init__(self, cin: int, features: int = 256, rates=(12, 24, 36),
                 dropout: float = 0.5, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.convs = nn.ModuleList(
            [ConvBNAct(cin, features, 1, dtype=dtype)]
            + [SeparableConvBNAct(cin, features, r, dtype) for r in rates]
            + [ASPPPooling(cin, features, dtype)])
        self.project = ConvBNAct(len(self.convs) * features, features, 1,
                                 dtype=dtype)
        self.dropout = dropout

    def forward(self, x, generator: Optional[torch.Generator] = None):
        y = self.project(torch.cat([m(x) for m in self.convs], dim=1))
        return dropout(y, self.dropout, generator) if self.training else y
