"""Reference `.pth` checkpoints into the PyTorch port, ported from
`enhanced_unet_tpu/convert/torch_import.py` (`load_torch_checkpoint`).

The port's modules carry the reference state dict's names (smp's
`unetpp.*`/`deeplab.*`, efficientnet-pytorch's encoder keys, the fusion
stage's; `model.encoder.` + torchvision's keys for the ResNet models), so
a reference checkpoint needs no conversion.  For `enhanced_unet` its
`model_state_dict` loads as it is; for the ResNet models its
`model.encoder.*` loads into the encoder and the rest is reported as
skipped, as the JAX package does.  Every key and shape is checked first,
so that a wrong file changes no weight.

Upstream encoders hold parts the port's do not: efficientnet-pytorch's
classifier head (`_conv_head`, the top-level `_bn1`, `_fc`: smp's
EfficientNet encoders delete `_fc` but keep the other two, which their
forward never calls; the upstream ImageNet files hold all three), and
torchvision's `fc` and the stages past a model's encoder depth, which no
forward of the zoo calls (`convert_resnet` never reads them).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn


_EFFNET_HEAD = ("_conv_head.", "_bn1.", "_fc.")


def is_effnet_head(key: str) -> bool:
    """True for a key of efficientnet-pytorch's classifier head (relative to
    the encoder): the 1x1 head conv, its BatchNorm (the top-level `_bn1`,
    not a block's) and the linear classifier."""
    return key.startswith(_EFFNET_HEAD)


def is_unused_upstream(key: str, encoder: nn.Module) -> bool:
    """True for a key of an upstream encoder file (relative to the encoder)
    that `encoder` does not hold and no forward calls: efficientnet-pytorch's
    classifier head, or torchvision's `fc` and stages past the encoder's
    depth."""
    if hasattr(encoder, "n_stages"):           # a ResNetEncoder
        if key.startswith("fc."):
            return True
        return key.startswith("layer") and int(key[5]) > encoder.n_stages
    return is_effnet_head(key)


def with_missing_counters(module: nn.Module, sd: Mapping[str, torch.Tensor]
                          ) -> Dict[str, torch.Tensor]:
    """`sd` with the module's own BatchNorm `num_batches_tracked` counters
    where it has none (torchvision's files predate them)."""
    out = dict(sd)
    for k, v in module.state_dict().items():
        if k.endswith("num_batches_tracked") and k not in out:
            out[k] = v
    return out


def check_exact(module: nn.Module, sd: Mapping[str, torch.Tensor], what: str) -> None:
    """Raise `ValueError` unless `sd`'s keys are `module`'s state-dict keys
    and every shape matches.  Called before `load_state_dict`, which copies
    the matching tensors before it reports the others, so that a wrong
    state dict writes nothing."""
    own = module.state_dict()
    missing = sorted(set(own) - set(sd))
    unexpected = sorted(set(sd) - set(own))
    if missing or unexpected:
        raise ValueError(f"{what}: {len(missing)} keys missing (first {missing[:3]}), "
                         f"{len(unexpected)} unexpected (first {unexpected[:3]})")
    wrong = [(k, tuple(sd[k].shape), tuple(v.shape)) for k, v in own.items()
             if tuple(sd[k].shape) != tuple(v.shape)]
    if wrong:
        raise ValueError(f"{what}: {len(wrong)} tensors of another shape, first "
                         f"{wrong[0][0]} {wrong[0][1]} (expected {wrong[0][2]})")


def _numpy_globals():
    """numpy's array and scalar constructors, which a reference history may
    hold, under both module paths a pickle may name (numpy 2 writes
    `numpy._core.multiarray`, numpy 1 `numpy.core.multiarray`)."""
    multiarray = getattr(np, "_core", None)
    multiarray = (multiarray if multiarray is not None else np.core).multiarray
    rebuild, scalar = multiarray._reconstruct, multiarray.scalar
    dtypes = {type(np.dtype(t)) for t in ("float64", "float32", "int64", "int32", "bool")}
    return [rebuild, scalar, np.ndarray, np.dtype, *dtypes,
            *((f, f"numpy.{core}.multiarray.{f.__name__}")
              for f in (rebuild, scalar) for core in ("core", "_core"))]


def _read_checkpoint(path: str) -> Dict[str, Any]:
    """`torch.load` of a reference checkpoint on the CPU, with
    `weights_only=True`: tensors, containers, numbers and numpy arrays,
    no other object."""
    with torch.serialization.safe_globals(_numpy_globals()):
        return torch.load(path, map_location="cpu", weights_only=True)


_ENCODER_PREFIX = "model.encoder."
_RESNET_MODELS = ("unet", "fcn", "pspnet", "linknet")


def load_torch_checkpoint(path_or_dict, state, model_name: str) -> Tuple[Any, Dict]:
    """Load a reference `.pth` training checkpoint (a path, or the dict it
    holds) into the port's `TrainState`, in place.

    The reference saves {epoch, model_state_dict, optimizer_state_dict,
    scheduler_state_dict, best_miou, best_loss, history}
    (train_eval.py:1143-1151).  For `enhanced_unet` its `model_state_dict`
    is loaded strictly (`check_exact`), less the two encoders' classifier
    heads (`_conv_head`, `_bn1`: smp keeps them, never calls them, and the
    port does not hold them), which are listed under `skipped`.  The UNet++
    head block's `x_0_4.attention1`, which smp creates but never calls and
    the JAX package skips, is loaded.  For the other models, as in the JAX
    package: the ResNet models' `model.encoder.*` (less what the encoder
    does not hold, `is_unused_upstream`) is loaded strictly into the
    encoder and reported under `imported`; the top-level names of every
    other key are reported under `skipped`.  Returns (state, report),
    report = {"imported": [...], "skipped": [...], "meta": {epoch,
    best_miou, best_loss, history}}, the JAX package's keys."""
    ckpt = _read_checkpoint(path_or_dict) if isinstance(path_or_dict, str) \
        else path_or_dict
    sd = ckpt.get("model_state_dict", ckpt)
    meta = {
        "epoch": int(ckpt.get("epoch", 0)),
        "best_miou": float(ckpt.get("best_miou", 0.0)),
        "best_loss": float(ckpt.get("best_loss", 0.0)),
        "history": ckpt.get("history", {}),
    }
    base = model_name[:-6] if model_name.endswith("_basic") else model_name
    if model_name == "enhanced_unet" or (
            base == "enhanced_unet" and any(k.startswith("unetpp.encoder.") for k in sd)):
        # a flagship checkpoint loads whole (and into EnhancedUNetBasic not at all)
        heads = ("unetpp.encoder.", "deeplab.encoder.")
        skipped = {k for k in sd for p in heads
                   if k.startswith(p) and is_effnet_head(k[len(p):])}
        sd = {k: v for k, v in sd.items() if k not in skipped}
        check_exact(state.model, sd, f"{model_name} checkpoint")
        state.model.load_state_dict(sd, strict=True)
        return state, {"imported": ["<full enhanced_unet state dict>"],
                       "skipped": sorted(skipped), "meta": meta}

    enc = {k[len(_ENCODER_PREFIX):]: v for k, v in sd.items()
           if k.startswith(_ENCODER_PREFIX)}
    imported = []
    if base in _RESNET_MODELS and enc:
        if model_name not in _RESNET_MODELS:
            raise ValueError(f"{model_name} has no ResNet encoder for the checkpoint's "
                             f"{_ENCODER_PREFIX}* keys")
        encoder = state.model.get_submodule(_ENCODER_PREFIX.rstrip("."))
        enc = with_missing_counters(
            encoder, {k: v for k, v in enc.items() if not is_unused_upstream(k, encoder)})
        check_exact(encoder, enc, f"{model_name} checkpoint's {_ENCODER_PREFIX}*")
        encoder.load_state_dict(enc, strict=True)
        imported.append(_ENCODER_PREFIX)
    consumed = _ENCODER_PREFIX if imported else None
    skipped = sorted({k.split(".")[0] for k in sd
                      if consumed is None or not k.startswith(consumed)})
    return state, {"imported": imported, "skipped": skipped, "meta": meta}
