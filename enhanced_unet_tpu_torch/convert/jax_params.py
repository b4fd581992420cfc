"""JAX variable trees -> PyTorch state dict of the port.

The inverse of `enhanced_unet_tpu/convert/torch_import.py`
(`convert_efficientnet`, `convert_unetpp_decoder`, `convert_deeplab_decoder`,
`convert_enhanced_unet`): numpy trees of the flax `EnhancedUNet`
(`params`, `batch_stats`) in, the port's `EnhancedUNet` state dict out.  The
result loads strictly: the keys the JAX tree has no values for (BatchNorm's
`num_batches_tracked` and the never-called `x_0_4.attention1` of the UNet++
head block) are filled with zeros.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from enhanced_unet_tpu_torch.models.encoders import expand_ratios

StateDict = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(sd: StateDict, key: str, p: Mapping) -> None:
    """flax conv {kernel HWIO[, bias]} -> torch `{key}.weight` OIHW[, bias]."""
    sd[f"{key}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _bn(sd: StateDict, key: str, p: Mapping, s: Mapping) -> None:
    sd[f"{key}.weight"] = _t(p["scale"])
    sd[f"{key}.bias"] = _t(p["bias"])
    sd[f"{key}.running_mean"] = _t(s["mean"])
    sd[f"{key}.running_var"] = _t(s["var"])
    sd[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _conv_bn(sd: StateDict, key: str, p: Mapping, s: Mapping) -> None:
    """ConvBNAct {Conv_0, BatchNorm_0} -> smp Conv2dReLU (`0` conv, `1` BN)."""
    _conv(sd, f"{key}.0", p["Conv_0"])
    _bn(sd, f"{key}.1", p["BatchNorm_0"], s["BatchNorm_0"])


def _scse(sd: StateDict, key: str, p: Mapping) -> None:
    _conv(sd, f"{key}.cSE.1", p["Conv_0"])
    _conv(sd, f"{key}.cSE.3", p["Conv_1"])
    _conv(sd, f"{key}.sSE.0", p["Conv_2"])


def _sepconv_bn(sd: StateDict, dw: str, pw: str, bn: str, p: Mapping,
                s: Mapping) -> None:
    _conv(sd, dw, p["Conv_0"])
    _conv(sd, pw, p["Conv_1"])
    _bn(sd, bn, p["BatchNorm_0"], s["BatchNorm_0"])


def _efficientnet(sd: StateDict, prefix: str, p: Mapping, s: Mapping,
                  variant: str) -> None:
    _conv(sd, f"{prefix}_conv_stem", p["Conv_0"])
    _bn(sd, f"{prefix}_bn0", p["BatchNorm_0"], s["BatchNorm_0"])
    for i, e in enumerate(expand_ratios(variant)):
        bp, bs = p[f"MBConvBlock_{i}"], s[f"MBConvBlock_{i}"]
        convs = ["_depthwise_conv", "_se_reduce", "_se_expand", "_project_conv"]
        bns = ["_bn1", "_bn2"]
        if e != 1:
            convs.insert(0, "_expand_conv")
            bns.insert(0, "_bn0")
        for j, name in enumerate(convs):
            _conv(sd, f"{prefix}_blocks.{i}.{name}", bp[f"Conv_{j}"])
        for j, name in enumerate(bns):
            _bn(sd, f"{prefix}_blocks.{i}.{name}", bp[f"BatchNorm_{j}"],
                bs[f"BatchNorm_{j}"])


def _decoder_block(sd: StateDict, key: str, p: Mapping, s: Mapping) -> None:
    dp, ds = p["DoubleConv_0"], s["DoubleConv_0"]
    _conv_bn(sd, f"{key}.conv1", dp["ConvBNAct_0"], ds["ConvBNAct_0"])
    _conv_bn(sd, f"{key}.conv2", dp["ConvBNAct_1"], ds["ConvBNAct_1"])


def _unetpp(sd: StateDict, prefix: str, p: Mapping, s: Mapping,
            variant: str) -> None:
    _efficientnet(sd, f"{prefix}encoder.", p["EfficientNetEncoder_0"],
                  s["EfficientNetEncoder_0"], variant)
    idx = 0
    for j in range(1, 5):
        for i in range(0, 5 - j):
            key = f"{prefix}decoder.blocks.x_{4 - i - j}_{3 - i}"
            bp, bs = p[f"NestedBlock_{idx}"], s[f"NestedBlock_{idx}"]
            _decoder_block(sd, key, bp, bs)
            _scse(sd, f"{key}.attention1.attention", bp["SCSEBlock_0"])
            _scse(sd, f"{key}.attention2.attention", bp["SCSEBlock_1"])
            idx += 1
    head = f"{prefix}decoder.blocks.x_0_4"
    _decoder_block(sd, head, p, s)
    _scse(sd, f"{head}.attention2.attention", p["SCSEBlock_0"])
    # smp creates the head block's attention1 but never calls it
    c = np.shape(p["DoubleConv_0"]["ConvBNAct_0"]["Conv_0"]["kernel"])[2]
    mid = max(c // 16, 1)
    unused = f"{head}.attention1.attention"
    for name, (o, i) in (("cSE.1", (mid, c)), ("cSE.3", (c, mid)),
                         ("sSE.0", (1, c))):
        sd[f"{unused}.{name}.weight"] = torch.zeros(o, i, 1, 1)
        sd[f"{unused}.{name}.bias"] = torch.zeros(o)
    _conv(sd, f"{prefix}segmentation_head.0", p["Conv_0"])


def _deeplab(sd: StateDict, prefix: str, p: Mapping, s: Mapping,
             variant: str) -> None:
    _efficientnet(sd, f"{prefix}encoder.", p["EfficientNetEncoder_0"],
                  s["EfficientNetEncoder_0"], variant)
    d = f"{prefix}decoder."
    ap, as_ = p["ASPP_0"], s["ASPP_0"]
    _conv_bn(sd, f"{d}aspp.0.convs.0", ap["ConvBNAct_0"], as_["ConvBNAct_0"])
    for b in range(1, 4):
        k = f"{d}aspp.0.convs.{b}"
        _sepconv_bn(sd, f"{k}.0.0", f"{k}.0.1", f"{k}.1",
                    ap[f"SeparableConvBNAct_{b - 1}"],
                    as_[f"SeparableConvBNAct_{b - 1}"])
    _conv(sd, f"{d}aspp.0.convs.4.1", ap["ConvBNAct_1"]["Conv_0"])
    _bn(sd, f"{d}aspp.0.convs.4.2", ap["ConvBNAct_1"]["BatchNorm_0"],
        as_["ConvBNAct_1"]["BatchNorm_0"])
    _conv_bn(sd, f"{d}aspp.0.project", ap["ConvBNAct_2"], as_["ConvBNAct_2"])
    _sepconv_bn(sd, f"{d}aspp.1.0", f"{d}aspp.1.1", f"{d}aspp.2",
                p["SeparableConvBNAct_0"], s["SeparableConvBNAct_0"])
    _conv_bn(sd, f"{d}block1", p["ConvBNAct_0"], s["ConvBNAct_0"])
    _sepconv_bn(sd, f"{d}block2.0.0", f"{d}block2.0.1", f"{d}block2.1",
                p["SeparableConvBNAct_1"], s["SeparableConvBNAct_1"])
    _conv(sd, f"{prefix}segmentation_head.0", p["Conv_0"])


def state_dict_from_jax(params: Mapping, batch_stats: Mapping,
                        variants: Tuple[str, str] = ("efficientnet-b5",
                                                     "efficientnet-b4"),
                        ) -> StateDict:
    """flax `EnhancedUNet` (params, batch_stats) -> port state dict.
    `variants` is the (UNet++, DeepLabV3+) encoder pair."""
    sd: StateDict = {}
    _unetpp(sd, "unetpp.", params["UNetPlusPlus_0"], batch_stats["UNetPlusPlus_0"],
            variants[0])
    _deeplab(sd, "deeplab.", params["DeepLabV3Plus_0"],
             batch_stats["DeepLabV3Plus_0"], variants[1])
    _conv(sd, "attention_gate.0", params["Conv_0"])
    _bn(sd, "attention_gate.1", params["BatchNorm_0"], batch_stats["BatchNorm_0"])
    _conv(sd, "attention_gate.3", params["Conv_1"])
    _bn(sd, "attention_gate.4", params["BatchNorm_1"], batch_stats["BatchNorm_1"])
    for k, off in enumerate((0, 4, 8)):
        _conv(sd, f"fusion_head.{off}", params[f"ConvBNAct_{k}"]["Conv_0"])
        _bn(sd, f"fusion_head.{off + 1}", params[f"ConvBNAct_{k}"]["BatchNorm_0"],
            batch_stats[f"ConvBNAct_{k}"]["BatchNorm_0"])
    _conv(sd, "fusion_head.11", params["Conv_2"])
    _conv(sd, "fusion_residual", params["Conv_3"])
    return sd
