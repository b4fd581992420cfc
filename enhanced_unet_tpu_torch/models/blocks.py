"""Building blocks of the model zoo, ported from
`enhanced_unet_tpu/models/blocks.py` (ConvBNAct, DoubleConv, the 2x2 pools
with and without indices, SCSEBlock, UpConcatBlock, SeparableConvBNAct, ASPP,
PSPModule).

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

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from enhanced_unet_tpu_torch.ops import partition
from enhanced_unet_tpu_torch.ops.kernels.conv_fused import (
    PackedConv3x3,
    fold_bn_params,
    fused_conv3x3_bn_relu_packed,
    pack_conv3x3,
)
from enhanced_unet_tpu_torch.ops.resize import (
    resize_bilinear_nchw,
    upsample2x_nchw,
    upsample2x_nearest_nchw,
)
from enhanced_unet_tpu_torch.utils.profiler import count


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
    (torch would update with the unbiased one).  Under tensor parallelism
    (`ops.partition`) train mode takes the whole batch's statistics over
    the ranks instead."""
    if not bn.training:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, False, 0.0, bn.eps)
    part = partition.active()        # a batch split over ranks, a channel slice
    if part is not None:
        return part.batch_norm(x, bn)
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
    1 - rate (a uniform draw below it) and scaled by 1 / (1 - rate).  Under
    tensor parallelism (`ops.partition`) a rank keeps its part of the draws
    over the whole batch."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    generator = need_generator(generator, "dropout")
    part = partition.active()
    # the draws in x's memory layout, so the select below runs on matching
    # strides (a channels_last x against an NCHW mask takes a slow strided path)
    u = (torch.empty_like(x, dtype=torch.float32).uniform_(generator=generator)
         if part is None else part.uniform(x, generator))
    mask = u < keep
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


def cached_weights(owner: nn.Module, slot: str, tensors, counter: str, make,
                   keep: bool = True):
    """`make()` under no autograd, kept on `owner` in `__dict__[slot]` and
    keyed by each tensor's `(data_ptr, _version)`, `owner.dtype` (the
    compute dtype) and the first tensor's device; made again when the key
    changes (`load_state_dict`, `.to()`, an in-place edit).  Each making
    counts `counter` (`utils.profiler`); `keep=False` makes it on every call
    and keeps nothing."""
    key = (tuple((t.data_ptr(), t._version) for t in tensors), owner.dtype,
           tensors[0].device)
    cached = owner.__dict__.get(slot)
    if keep and cached is not None and cached[0] == key:
        return cached[1]
    count(counter)
    with torch.inference_mode(False), torch.no_grad():
        made = make()
    if keep:
        owner.__dict__[slot] = (key, made)
    return made


def packed_conv3x3(layer: nn.Conv2d, bn: Optional[nn.BatchNorm2d],
                   dtype: torch.dtype, device: torch.device,
                   cout_slice: Optional[Tuple[int, int]] = None,
                   epilogue: bool = True) -> PackedConv3x3:
    """The fused kernel's weights for `layer` + `bn` (BN folded, cast,
    permuted), packed once and kept on `layer`.  Without `bn` the scale is 1
    and the shift the conv's bias.  `cout_slice` = (lo, hi): the layer's
    weight holds output channels [lo, hi) of its BN's and bias's (tensor
    parallelism's column split, `ops.partition`), and those are folded.
    `epilogue=False`: scale 1 and shift 0, the BN and the bias left to the
    caller (a row split's partial sums).  They are packed again when the
    conv weight or bias or a BN tensor is replaced or edited in place
    (`load_state_dict`, `.to()`, `weight.mul_`: a new `data_ptr` or
    `_version`), or for another dtype, device, slice or epilogue; each
    packing counts `kernels.k2_pack` (`utils.profiler`)."""
    tensors = [layer.weight, layer.bias]
    if bn is not None:
        tensors += [bn.weight, bn.bias, bn.running_mean, bn.running_var]
    key = (tuple(None if t is None else (t.data_ptr(), t._version) for t in tensors),
           None if bn is None else bn.eps, dtype, device, cout_slice, epilogue)
    cached = layer.__dict__.get("_packed_conv3x3")
    if cached is not None and cached[0] == key:
        return cached[1]
    count("kernels.k2_pack")
    lo, hi = cout_slice or (0, layer.weight.shape[0])
    bias = None if layer.bias is None else layer.bias[lo:hi]
    scale = torch.ones_like(layer.weight[:, 0, 0, 0])
    shift = torch.zeros_like(scale)
    if epilogue and bn is not None:
        scale, shift = fold_bn_params(bn.weight[lo:hi], bn.bias[lo:hi],
                                      bn.running_mean[lo:hi], bn.running_var[lo:hi],
                                      bn.eps, bias)
    elif epilogue and bias is not None:
        shift = bias
    packed = pack_conv3x3(layer.weight.permute(2, 3, 1, 0), scale, shift, dtype,
                          device)
    layer.__dict__["_packed_conv3x3"] = (key, packed)
    return packed


def row_split(layer: nn.Module) -> nn.Module:
    """Mark `layer` as the conv of its block's second ConvBNAct (the JAX
    package's `ConvBNAct_1`): tensor parallelism splits its input channels
    (`parallel.tensor_parallel.tp_param_specs`).  Returns `layer`."""
    layer.tp_row_split = True
    return layer


def conv_bn_act(x: torch.Tensor, layer: nn.Conv2d, bn: Optional[nn.BatchNorm2d],
                relu: bool, dtype: torch.dtype) -> torch.Tensor:
    """Conv -> BN (none when `bn` is None: the conv's bias alone) ->
    optional ReLU.  In eval mode a 3x3, stride-1, undilated, ungrouped conv
    goes through the fused conv3x3+BN+ReLU kernel with its weights packed
    once (its plain version on the CPU; under a partitioned run, a band of
    rows or a channel slice, as the run says: `ops.partition`), and raises
    when autograd would record it; train mode (batch statistics, which a
    folded BN cannot give) and any other conv run as plain PyTorch."""
    training = layer.training if bn is None else bn.training
    if (not training and layer.kernel_size == (3, 3) and layer.stride == (1, 1)
            and layer.dilation == (1, 1) and layer.groups == 1):
        params = [layer.weight, layer.bias] + ([] if bn is None else [bn.weight, bn.bias])
        refuse_autograd(f"3x3 ConvBNAct {layer.in_channels}->{layer.out_channels}",
                        [p for p in params if p is not None])

        def fused(x, own=None, packed=None, relu=relu):
            xh = x.to(dtype).permute(0, 2, 3, 1).contiguous()
            y = fused_conv3x3_bn_relu_packed(
                xh, packed or packed_conv3x3(layer, bn, dtype, xh.device), relu=relu)
            return y.permute(0, 3, 1, 2)

        part = partition.active()       # a band of rows or a channel slice
        return fused(x) if part is None else part.conv3x3(x, layer, bn, relu, dtype, fused)
    y = conv(x, layer, dtype)
    if bn is not None:
        y = batch_norm(y, bn)
    return torch.relu(y) if relu else y


class ConvBNAct(nn.Sequential):
    """Conv2d -> BatchNorm -> ReLU or no activation.  State-dict layout of
    smp's `Conv2dReLU` (`0` conv, `1` BN).  The conv has no bias (a bias
    before BN is dead), except with `use_bn=False`, where the bias stands
    in for the BN (`0` conv alone).  Padding is symmetric `k // 2`, which
    equals TF SAME at stride 1 and is the JAX package's `padding="torch"`."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3, stride: int = 1,
                 act: Optional[str] = "relu", use_bn: bool = True, eps: float = 1e-5,
                 dtype: torch.dtype = torch.bfloat16):
        layers = [nn.Conv2d(cin, cout, kernel_size, stride, padding=kernel_size // 2,
                            bias=not use_bn)]
        if use_bn:
            layers.append(nn.BatchNorm2d(cout, eps=eps))
        super().__init__(*layers)
        if act not in ("relu", None):
            raise ValueError(f"unsupported activation {act}")
        self.act = act
        self.use_bn = use_bn
        self.dtype = dtype

    def forward(self, x):
        return conv_bn_act(x, self[0], self[1] if self.use_bn else None,
                           self.act == "relu", self.dtype)


class DoubleConv(nn.Module):
    """Two 3x3 ConvBNAct blocks (`conv1`, `conv2`, as in smp's
    DecoderBlock)."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv1 = ConvBNAct(cin, cout, dtype=dtype)
        self.conv2 = ConvBNAct(cout, cout, dtype=dtype)
        row_split(self.conv2[0])

    def forward(self, x):
        return self.conv2(self.conv1(x))


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """`nn.MaxPool2d(2, 2)` on NCHW."""
    return F.max_pool2d(x, 2)


def max_pool_with_indices(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """2x2 max pool of NCHW `x` with each window's argmax: (pooled
    [N,C,H/2,W/2], idx of the same shape in 0..3, row-major in the window).
    The index is that of the first maximum, as `jnp.argmax` gives it (reshape
    + `torch.argmax`); `F.max_pool2d(return_indices=True)` breaks ties
    otherwise, and ties are common in bf16."""
    n, c, h, w = x.shape
    xr = x.reshape(n, c, h // 2, 2, w // 2, 2).permute(0, 1, 2, 4, 3, 5)
    xr = xr.reshape(n, c, h // 2, w // 2, 4)
    return xr.amax(dim=-1), xr.argmax(dim=-1)


def max_unpool_2x2(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Inverse of `max_pool_with_indices`: each value back at its argmax
    position, zeros elsewhere (torch `MaxUnpool2d`'s result)."""
    n, c, h2, w2 = x.shape
    onehot = F.one_hot(idx, 4).to(x.dtype)                 # [N,C,H2,W2,4]
    out = (onehot * x[..., None]).reshape(n, c, h2, w2, 2, 2).permute(0, 1, 2, 4, 3, 5)
    return out.reshape(n, c, 2 * h2, 2 * w2)


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
                         row_split(nn.Conv2d(cin, cout, 1, bias=False)),
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


class UpConcatBlock(nn.Sequential):
    """The UNet decoder step: 2x upsample (nearest, as smp's decoder blocks;
    bilinear for the reference's BasicUNet), concat with the skip and two
    3x3 ConvBNActs (`0`, `1`)."""

    def __init__(self, cin: int, skip: int, cout: int, bilinear: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(ConvBNAct(cin + skip, cout, dtype=dtype),
                         ConvBNAct(cout, cout, dtype=dtype))
        row_split(self[1][0])
        self.bilinear = bilinear

    def forward(self, x, skip=None):
        x = upsample2x_nchw(x) if self.bilinear else upsample2x_nearest_nchw(x)
        if skip is not None:
            x = torch.cat([x, skip.to(x.dtype)], dim=1)
        for m in self:
            x = m(x)
        return x


def _adaptive_avg_pool(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """`AdaptiveAvgPool2d(out_size)`: bin i spans floor(i * H / out) to
    ceil((i + 1) * H / out), equal bins when H divides."""
    return F.adaptive_avg_pool2d(x, out_size)


class PSPModule(nn.Module):
    """Pyramid pooling: for each bin size, adaptive average pooling, a 1x1
    ConvBNAct (`stages.{i}`) and a bilinear resize back; concatenated after
    the input."""

    def __init__(self, cin: int, features: int = 64,
                 bin_sizes: Sequence[int] = (1, 2, 3, 6),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.bin_sizes = tuple(bin_sizes)
        self.stages = nn.ModuleList([ConvBNAct(cin, features, 1, dtype=dtype)
                                     for _ in self.bin_sizes])
        row_split(self.stages[1][0])

    def forward(self, x):
        size = x.shape[2:]
        outs = [x]
        for b, stage in zip(self.bin_sizes, self.stages):
            pooled = stage(_adaptive_avg_pool(x, b))
            outs.append(resize_bilinear_nchw(pooled, size).to(x.dtype))
        return torch.cat(outs, dim=1)


class NHWCModel(nn.Module):
    """A zoo model: `model(x_nhwc, generator=None) -> (logits_nhwc_f32, {})`.
    Subclasses compute `logits(x_nchw, generator)`; on the card the input
    goes in channels_last.  `generator` draws train-mode dropout."""

    def forward(self, x_nhwc: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        x = x_nhwc.permute(0, 3, 1, 2)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        return self.logits(x, generator).float().permute(0, 2, 3, 1), {}
