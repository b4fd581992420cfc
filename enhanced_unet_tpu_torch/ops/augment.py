"""Training augmentation, ported from `enhanced_unet_tpu/ops/augment.py`
(`augment_train`): the reference's 8-stage pipeline (flips; brightness and
contrast with ranges set by the live/dead ratio; saturation; random CLAHE;
Gaussian noise; gamma; sharpen; HSV jitter), batched on the device.

It is split in two so that the arithmetic can be held against the JAX
package on JAX's own draws:

- `augment_params` draws, per sample, every uniform and the noise field
  that the JAX function draws, from a `torch.Generator` on the device;
- `apply_augment` is deterministic: every stage runs on the whole batch,
  and each sample keeps the stage's result where its draw selects it
  (`torch.where` on a [B, 1, 1, 1] condition), as `vmap` of the JAX
  function does.

The draws' distributions match JAX's; the bitstreams cannot (the deviation
the JAX package documents against the reference's Python `random`).
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import torch

from enhanced_unet_tpu_torch.ops.preprocess import (
    _SHARPEN,
    _conv2d_same,
    _u8_round,
    _u8_trunc,
    clahe_dynamic,
    hsv_to_rgb_u8,
    lab_to_rgb_u8,
    rgb_to_hsv_u8,
    rgb_to_lab_u8,
)

# One U[0, 1) draw per sample each: `p_*` decides whether a stage applies,
# `u_*` sets its strength.
UNIFORMS = ("p_hflip", "p_vflip", "p_brightness", "u_brightness", "p_contrast",
            "u_contrast", "p_saturation", "u_saturation", "p_clahe", "u_clahe",
            "p_noise", "u_noise", "p_gamma", "u_gamma", "p_sharpen", "u_sharpen",
            "p_jitter", "u_hue", "u_value")


def augment_params(generator: torch.Generator, n: int, h: int, w: int,
                   device: Union[str, torch.device]) -> Dict[str, torch.Tensor]:
    """The draws of `n` samples of h x w: each name of `UNIFORMS` -> [n]
    fp32 in [0, 1), and `noise` -> [n, h, w, 3] standard normal, all on
    `device` (the generator's)."""
    params = {name: torch.rand(n, generator=generator, device=device) for name in UNIFORMS}
    params["noise"] = torch.randn((n, h, w, 3), generator=generator, device=device)
    return params


def _pick(draw: torch.Tensor, threshold: float, new: torch.Tensor,
          old: torch.Tensor) -> torch.Tensor:
    """`new` for the samples whose draw exceeds `threshold`, else `old`."""
    cond = (draw > threshold).reshape(-1, *([1] * (old.dim() - 1)))
    return torch.where(cond, new, old)


def apply_augment(images: torch.Tensor, masks: torch.Tensor,
                  params: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Augment uint8-domain [B, H, W, 3] images and their [B, H, W]
    semantic masks (0 background, 1 live, 2 dead) with `params`
    (`augment_params`).  Returns (images fp32, masks), same shapes and
    domains."""
    p = params
    image = images.to(torch.float32)
    b, h, w = image.shape[:3]

    # flips, image and mask together
    image = _pick(p["p_hflip"], 0.5, image.flip(2), image)
    masks = _pick(p["p_hflip"], 0.5, masks.flip(2), masks)
    image = _pick(p["p_vflip"], 0.5, image.flip(1), image)
    masks = _pick(p["p_vflip"], 0.5, masks.flip(1), masks)

    # the live share of the labelled pixels, after the flips
    live_px = (masks == 1).sum(dim=(1, 2))
    total = live_px + (masks == 2).sum(dim=(1, 2))
    live_ratio = torch.where(total > 0, live_px / torch.clamp(total, min=1),
                             torch.full_like(live_px, 0.5, dtype=torch.float32))

    def scalar(v):
        return torch.full_like(live_ratio, v)

    def column(v):
        return v.reshape(-1, 1, 1, 1)

    # 1. brightness
    lo = torch.where(live_ratio > 0.6, scalar(0.8),
                     torch.where(live_ratio < 0.4, scalar(0.6), scalar(0.7)))
    hi = torch.where(live_ratio > 0.6, scalar(1.3),
                     torch.where(live_ratio < 0.4, scalar(1.1), scalar(1.3)))
    alpha = lo + p["u_brightness"] * (hi - lo)
    image = _pick(p["p_brightness"], 0.3, _u8_trunc(image * column(alpha)), image)

    # 2. contrast shift
    blo = torch.where(live_ratio < 0.4, scalar(-20.0), scalar(-30.0))
    bhi = torch.where(live_ratio < 0.4, scalar(40.0), scalar(30.0))
    beta = blo + p["u_contrast"] * (bhi - blo)
    image = _pick(p["p_contrast"], 0.3, _u8_trunc(image + column(beta)), image)

    # 3. saturation (the float HSV truncated to uint8 before converting back)
    sat = 0.8 + p["u_saturation"] * 0.5
    hsv = rgb_to_hsv_u8(image)
    hsv = torch.cat([hsv[..., :1], torch.clamp(hsv[..., 1:2] * column(sat), 0, 255),
                     hsv[..., 2:]], dim=-1)
    image = _pick(p["p_saturation"], 0.5, hsv_to_rgb_u8(torch.floor(hsv)), image)

    # 4. random CLAHE on L, one clip threshold per sample
    clip_limit = 1.5 + p["u_clahe"] * 1.5
    tile_area = (h // 8) * (w // 8)
    clip = torch.clamp(torch.floor(clip_limit * tile_area / 256.0), min=1).to(torch.int64)
    lab = rgb_to_lab_u8(image)
    l_enh = clahe_dynamic(lab[..., 0], clip)
    clahe_img = lab_to_rgb_u8(torch.cat([l_enh[..., None], lab[..., 1:]], dim=-1))
    image = _pick(p["p_clahe"], 0.4, clahe_img, image)

    # 5. Gaussian noise
    sigma = 3.0 + p["u_noise"] * 7.0
    image = _pick(p["p_noise"], 0.5, _u8_trunc(image + p["noise"] * column(sigma)), image)

    # 6. gamma
    gamma = 0.7 + p["u_gamma"] * 0.6
    gamma_img = torch.floor((image / 255.0) ** column(1.0 / gamma) * 255.0)
    image = _pick(p["p_gamma"], 0.5, gamma_img, image)

    # 7. sharpen, one kernel per sample
    strength = 0.1 + p["u_sharpen"] * 0.2
    kernels = torch.stack([strength * v for row in _SHARPEN for v in row], -1).reshape(-1, 3, 3)
    sharp = _u8_trunc(_u8_round(_conv2d_same(image, kernels)))
    image = _pick(p["p_sharpen"], 0.6, sharp, image)

    # 8. HSV jitter: hue shifted mod 180 (Python's sign rule), value scaled
    dh = -10.0 + p["u_hue"] * 20.0
    dv = 0.9 + p["u_value"] * 0.2
    hsv = rgb_to_hsv_u8(image)
    hsv = torch.stack([torch.remainder(hsv[..., 0] + dh.reshape(-1, 1, 1), 180.0),
                       hsv[..., 1],
                       torch.clamp(hsv[..., 2] * dv.reshape(-1, 1, 1), 0, 255)], dim=-1)
    image = _pick(p["p_jitter"], 0.6, hsv_to_rgb_u8(torch.floor(hsv)), image)
    return image, masks


def augment_train(generator: torch.Generator, images: torch.Tensor,
                  masks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw with `generator` (on the images' device) and augment the batch."""
    b, h, w = images.shape[:3]
    return apply_augment(images, masks, augment_params(generator, b, h, w, images.device))
