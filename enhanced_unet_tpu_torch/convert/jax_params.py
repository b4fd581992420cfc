"""JAX variable trees -> PyTorch state dict of the port.

The inverse of `enhanced_unet_tpu/convert/torch_import.py`
(`convert_efficientnet`, `convert_unetpp_decoder`, `convert_deeplab_decoder`,
`convert_enhanced_unet`): numpy trees of the flax `EnhancedUNet`
(`params`, `batch_stats`) in, the port's `EnhancedUNet` state dict out.  The
result loads strictly: the keys the JAX tree has no values for (BatchNorm's
`num_batches_tracked` and the never-called `x_0_4.attention1` of the UNet++
head block) are filled with zeros.

A JAX `TrainState` taken mid-training carries over too: the first and
second moments of its optax `chain(clip_by_global_norm, adamw)` state have
the parameters' tree and go through the same key map (`resume_from_jax`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from enhanced_unet_tpu_torch.models.encoders import expand_ratios
from enhanced_unet_tpu_torch.train.trainer import AdamWState, TrainState

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


_STATS_KEYS = ("running_mean", "running_var", "num_batches_tracked")


def _stats_like(tree: Mapping) -> Dict:
    """A stand-in `batch_stats` tree for a params-shaped tree, so the weight
    key map walks it: each BatchNorm's {scale, bias} gives {mean, var}."""
    if "scale" in tree and "bias" in tree:
        return {"mean": tree["scale"], "var": tree["scale"]}
    return {k: _stats_like(v) for k, v in tree.items() if isinstance(v, Mapping)}


def _param_tree_to_port(tree: Mapping, variants: Tuple[str, str]) -> StateDict:
    """A tree shaped like the flax params (a gradient, a moment) -> the same
    values under the port's parameter names."""
    sd = state_dict_from_jax(tree, _stats_like(tree), variants)
    return {k: v for k, v in sd.items() if not k.endswith(_STATS_KEYS)}


def _adam_state(opt_state: Any):
    """The `ScaleByAdamState` (count, mu, nu) inside an optax state."""
    if all(hasattr(opt_state, a) for a in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = _adam_state(sub)
            if found is not None:
                return found
    return None


def optimizer_state_from_jax(opt_state: Any,
                             variants: Tuple[str, str] = ("efficientnet-b5",
                                                          "efficientnet-b4"),
                             mu_dtype: torch.dtype = torch.float32,
                             device="cpu") -> AdamWState:
    """An optax `chain(clip_by_global_norm, adamw)` state -> the port's
    `AdamWState` (mu in `mu_dtype`, nu fp32) on `device`."""
    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the optimizer state")

    def moments(tree, dtype):
        return {k: v.to(device=device, dtype=dtype)
                for k, v in _param_tree_to_port(tree, variants).items()}

    return AdamWState(count=int(np.asarray(adam.count)),
                      mu=moments(adam.mu, mu_dtype), nu=moments(adam.nu, torch.float32))


def resume_from_jax(state: TrainState, params: Mapping, batch_stats: Mapping,
                    opt_state: Any, variants: Tuple[str, str] = ("efficientnet-b5",
                                                                 "efficientnet-b4"),
                    ) -> TrainState:
    """The trees of a JAX `TrainState` (params, batch_stats, opt_state)
    loaded into the port's `state`: weights and running statistics into its
    model, the moments and the update count into its optimizer state."""
    state.model.load_state_dict(state_dict_from_jax(params, batch_stats, variants))
    device = next(state.model.parameters()).device
    opt = optimizer_state_from_jax(opt_state, variants, state.tx.mu_dtype, device)
    return dataclasses.replace(state, step=opt.count, opt_state=opt)
