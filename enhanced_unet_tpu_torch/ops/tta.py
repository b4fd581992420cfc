"""Test-time augmentation, ported from `enhanced_unet_tpu/ops/tta.py`:
identity + hflip + vflip + 0.75x + 1.25x, probabilities averaged.

Images are NHWC (or HWC) float tensors in [0, 1].  `apply_fn` maps
[N, H, W, 3] images to [N, H, W, C] logits.  Under a profiler
`tta_probs_batch` records a `serve.tta` span (`utils.profiler`).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from enhanced_unet_tpu_torch.ops.resize import pad_to_multiple, resize_bilinear
from enhanced_unet_tpu_torch.utils.profiler import span

ApplyFn = Callable[[torch.Tensor], torch.Tensor]


def _probs(apply_fn: ApplyFn, images: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Reflect-pad to a multiple of 32, forward, softmax, crop to (h, w)."""
    padded, _ = pad_to_multiple(images, 32, mode="reflect")
    logits = apply_fn(padded)
    if logits.shape[1:3] != padded.shape[1:3]:
        logits = resize_bilinear(logits, padded.shape[1:3])
    return torch.softmax(logits.float(), dim=-1)[:, :h, :w]


def run_model_single(apply_fn: ApplyFn, image: torch.Tensor) -> torch.Tensor:
    """[H, W, 3] image -> [H, W, C] probabilities."""
    h, w = image.shape[:2]
    return _probs(apply_fn, image[None], h, w)[0]


def tta_probs_batch(apply_fn: ApplyFn, images: torch.Tensor,
                    enable_tta: bool = True,
                    scales: Tuple[float, ...] = (0.75, 1.25)) -> torch.Tensor:
    """[B, H, W, 3] -> [B, H, W, C] averaged probabilities.  The same-size
    trio (identity, hflip, vflip) runs as one [3B, ...] forward, each scale
    as one [B, ...] forward."""
    b, h, w = images.shape[:3]
    with span("serve.tta", device=images.device, views=3 + len(scales) if enable_tta else 1):
        if not enable_tta:
            return _probs(apply_fn, images, h, w)
        trio = torch.cat([images, images.flip(2), images.flip(1)])
        probs = _probs(apply_fn, trio, h, w)
        acc = [probs[:b], probs[b:2 * b].flip(2), probs[2 * b:].flip(1)]
        for s in scales:
            sh, sw = int(h * s), int(w * s)
            p = _probs(apply_fn, resize_bilinear(images, (sh, sw)), sh, sw)
            acc.append(resize_bilinear(p, (h, w)))
        return torch.stack(acc).mean(dim=0)


def tta_probs(apply_fn: ApplyFn, image: torch.Tensor, enable_tta: bool = True,
              scales: Tuple[float, ...] = (0.75, 1.25)) -> torch.Tensor:
    """[H, W, 3] -> [H, W, C] averaged probabilities."""
    return tta_probs_batch(apply_fn, image[None], enable_tta, scales)[0]
