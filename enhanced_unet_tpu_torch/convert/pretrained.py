"""ImageNet-pretrained encoders (reference models.py:255-275), ported from
`enhanced_unet_tpu/convert/pretrained.py`.

The reference trains from smp encoders that hold upstream ImageNet weights:
torchvision's ResNets and lukemelas/efficientnet-pytorch's EfficientNets.
`WEIGHT_MANIFEST` names those files; download them anywhere with network
access into one directory, and `initialize_pretrained(state, model_name,
weights_dir)` loads them into a fresh `TrainState`.  The port's encoders
use the upstream key names (efficientnet-pytorch's `_conv_stem`, `_bn0`,
`_blocks.{i}.*`; torchvision's `conv1`, `bn1`, `layer{i}.*`), so a file
loads as it is, less what no encoder of the reference calls
(`torch_import.is_unused_upstream`: efficientnet-pytorch's classifier
head, torchvision's `fc` and the stages past the model's encoder depth).

File integrity: torch.hub's convention embeds the first 8 hex digits of
the file's SHA256 in its name; `verify_weight_file` checks it.
"""

from __future__ import annotations

import hashlib
import os
import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

from enhanced_unet_tpu_torch.convert.torch_import import (
    check_exact,
    is_unused_upstream,
    with_missing_counters,
)

# Upstream weight files, exactly as segmentation_models_pytorch resolves
# them for the reference's six models (models.py:182-192, 255-275, 353-362,
# 430-440, 520-529).  The filename's 8-hex suffix is torch.hub's SHA256
# prefix.
WEIGHT_MANIFEST: Dict[str, Dict[str, Any]] = {
    "resnet18": {
        "file": "resnet18-5c106cde.pth",
        "url": "https://download.pytorch.org/models/resnet18-5c106cde.pth",
        "sha256_prefix": "5c106cde",
        "used_by": ["fcn", "linknet"],
    },
    "resnet34": {
        "file": "resnet34-333f7ec4.pth",
        "url": "https://download.pytorch.org/models/resnet34-333f7ec4.pth",
        "sha256_prefix": "333f7ec4",
        "used_by": ["pspnet"],
    },
    "resnet50": {
        "file": "resnet50-19c8e357.pth",
        "url": "https://download.pytorch.org/models/resnet50-19c8e357.pth",
        "sha256_prefix": "19c8e357",
        "used_by": ["unet"],
    },
    "efficientnet-b4": {
        "file": "efficientnet-b4-6ed6700e.pth",
        "url": ("https://github.com/lukemelas/EfficientNet-PyTorch/releases/"
                "download/1.0/efficientnet-b4-6ed6700e.pth"),
        "sha256_prefix": "6ed6700e",
        "used_by": ["enhanced_unet (deeplab branch)"],
    },
    "efficientnet-b5": {
        "file": "efficientnet-b5-b6417697.pth",
        "url": ("https://github.com/lukemelas/EfficientNet-PyTorch/releases/"
                "download/1.0/efficientnet-b5-b6417697.pth"),
        "sha256_prefix": "b6417697",
        "used_by": ["enhanced_unet (unetpp branch)"],
    },
}

# model name -> encoder (the reference state dict's key prefix) -> manifest key
_MODEL_VARIANTS: Dict[str, Dict[str, str]] = {
    "enhanced_unet": {"unetpp.encoder.": "efficientnet-b5",
                      "deeplab.encoder.": "efficientnet-b4"},
    "unet": {"model.encoder.": "resnet50"},
    "fcn": {"model.encoder.": "resnet18"},
    "pspnet": {"model.encoder.": "resnet34"},
    "linknet": {"model.encoder.": "resnet18"},
}


def verify_weight_file(path: str) -> bool:
    """True iff the file's SHA256 starts with the 8-hex prefix embedded in
    its torch.hub-style filename (``name-<prefix8>.pth``)."""
    m = re.match(r".*-([0-9a-f]{8})\.pth$", os.path.basename(path))
    if not m:
        raise ValueError(f"{path}: not a torch.hub-style weight filename")
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest().startswith(m.group(1))


def required_weights(model_name: str) -> Dict[str, Dict[str, Any]]:
    """Manifest entries a model's pretrained init needs (empty for the
    *_basic fallbacks and segnet, which have no smp encoders and train from
    scratch in the reference too, models.py:79-172, 199-240)."""
    roles = _MODEL_VARIANTS.get(model_name, {})
    return {v: WEIGHT_MANIFEST[v] for v in roles.values()}


def _read_weights(weights_dir: Optional[str], variant: str,
                  verify: bool) -> Mapping[str, torch.Tensor]:
    entry = WEIGHT_MANIFEST[variant]
    path = os.path.join(weights_dir or ".", entry["file"])
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path} not found; download it from {entry['url']}")
    if verify and not verify_weight_file(path):
        raise ValueError(f"{path}: SHA256 does not match the {entry['sha256_prefix']} "
                         "prefix in its filename")
    return torch.load(path, map_location="cpu", weights_only=True)


def initialize_pretrained(state, model_name: str, weights_dir: Optional[str] = None,
                          state_dicts: Optional[Mapping[str, Mapping[str, Any]]] = None,
                          verify: bool = True, log=print) -> Tuple[Any, List[str]]:
    """Load ImageNet-pretrained encoder weights into a fresh `TrainState`,
    in place: for `enhanced_unet`, efficientnet-b5 into
    `state.model.unetpp.encoder` and efficientnet-b4 into
    `state.model.deeplab.encoder`; for `unet`, `fcn`, `pspnet` and
    `linknet`, their torchvision ResNet into `state.model.model.encoder`.

    weights_dir: the directory that holds the manifest's files; state_dicts:
    {variant: raw upstream state dict} in their place.  What the encoder does
    not hold and never calls (the classifier heads, `fc.*`, the ResNet
    stages past the encoder's depth) is dropped, and missing BatchNorm
    `num_batches_tracked` counters keep the encoder's; every other key must
    be the encoder's, with its shape, or it raises before any weight is
    written.  Returns (state, imported variants)."""
    roles = _MODEL_VARIANTS.get(model_name)
    if not roles:
        raise ValueError(
            f"{model_name} has no pretrained encoders (reference trains it "
            "from scratch)")
    loads = []
    for prefix, variant in roles.items():
        path = prefix.rstrip(".")
        encoder = state.model.get_submodule(path)
        sd = (state_dicts[variant] if state_dicts is not None
              else _read_weights(weights_dir, variant, verify))
        sd = with_missing_counters(
            encoder, {k: v for k, v in sd.items() if not is_unused_upstream(k, encoder)})
        check_exact(encoder, sd, f"{variant} into {path}")
        loads.append((encoder, path, variant, sd))
    # every file is checked before the first encoder is written
    imported = []
    for encoder, path, variant, sd in loads:
        encoder.load_state_dict(sd, strict=True)
        imported.append(variant)
        log(f"initialized {path} from {variant} ImageNet weights")
    return state, imported
