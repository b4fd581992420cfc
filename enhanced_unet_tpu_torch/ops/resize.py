"""Resizes and padding, matching `enhanced_unet_tpu/ops/resize.py`.

Public functions take the JAX package's channel-last layout (NHWC or HWC).
The `*_nchw` helpers are what the models call on their NCHW tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _nhwc_call(x: torch.Tensor, fn) -> torch.Tensor:
    if x.ndim == 3:
        return fn(x.permute(2, 0, 1)[None])[0].permute(1, 2, 0)
    if x.ndim == 4:
        return fn(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    raise ValueError(f"expected 3D/4D input, got shape {tuple(x.shape)}")


def resize_bilinear_nchw(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Half-pixel bilinear resize (`align_corners=False`, no antialias)."""
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=False)


def resize_bilinear_align_corners_nchw(x: torch.Tensor,
                                       size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize with `align_corners=True`, computed in fp32 and cast
    back to the input dtype (as the JAX version does)."""
    y = F.interpolate(x.float(), size=tuple(size), mode="bilinear",
                      align_corners=True)
    return y.to(x.dtype)


def upsample2x_nchw(x: torch.Tensor) -> torch.Tensor:
    """`nn.Upsample(scale_factor=2, mode="bilinear", align_corners=False)`."""
    return resize_bilinear_nchw(x, (x.shape[-2] * 2, x.shape[-1] * 2))


def upsample2x_nearest_nchw(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """NHWC/HWC resize to `size` = (H, W), torch `F.interpolate` semantics."""
    return _nhwc_call(x, lambda t: resize_bilinear_nchw(t, size))


def resize_bilinear_align_corners(x: torch.Tensor,
                                  size: Tuple[int, int]) -> torch.Tensor:
    return _nhwc_call(x, lambda t: resize_bilinear_align_corners_nchw(t, size))


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """NHWC/HWC bilinear 2x upsample (half-pixel, as `F.interpolate`)."""
    return _nhwc_call(x, upsample2x_nchw)


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    return _nhwc_call(x, upsample2x_nearest_nchw)


def pad_to_multiple(x: torch.Tensor, multiple: int = 32,
                    mode: str = "reflect") -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Bottom/right pad H, W of NHWC (or HWC) to the next multiple.
    Returns (padded, (h_pad, w_pad))."""
    h, w = x.shape[-3], x.shape[-2]
    h_pad = (multiple - h % multiple) % multiple
    w_pad = (multiple - w % multiple) % multiple
    if h_pad == 0 and w_pad == 0:
        return x, (0, 0)
    padded = _nhwc_call(x, lambda t: F.pad(t, (0, w_pad, 0, h_pad), mode=mode))
    return padded, (h_pad, w_pad)
