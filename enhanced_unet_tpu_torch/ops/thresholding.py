"""Probabilities -> semantic mask: the threshold cascade of
`enhanced_unet_tpu/ops/thresholding.py`, rule for rule.

Input [..., H, W, 3] (background, live, dead) probabilities; the density
ratios of the re-thresholding rules are taken per image, over H and W only,
so a batch dim gives the same masks as one image at a time.
"""

from __future__ import annotations

import torch


def convert_probs_to_mask(probs: torch.Tensor) -> torch.Tensor:
    """Apply the cascade; returns an int32 mask [..., H, W]."""
    bg, live, dead = probs[..., 0], probs[..., 1], probs[..., 2]
    pred = torch.argmax(probs, dim=-1).to(torch.int32)
    max_prob = torch.amax(probs, dim=-1)
    zero = torch.zeros_like(pred)

    # live / dead low-confidence -> background
    live_low = (pred == 1) & ((live < 0.42) | (live <= bg * 1.15))
    pred = torch.where(live_low, zero, pred)
    dead_low = (pred == 2) & ((dead < 0.5) | (dead <= bg * 1.3) | (bg > 0.3)
                              | (live > dead * 0.9))
    pred = torch.where(dead_low, zero, pred)

    # background reclaimed as live, then as dead
    bg_high_live = ((pred == 0) & (live > 0.42) & (live > bg * 1.15)
                    & (live > dead * 1.05))
    pred = torch.where(bg_high_live, zero + 1, pred)
    bg_high_dead = ((pred == 0) & (dead > 0.5) & (dead > bg * 1.3)
                    & (dead > live * 1.1) & (bg < 0.3) & ~bg_high_live)
    pred = torch.where(bg_high_dead, zero + 2, pred)

    # class swaps
    pred = torch.where((pred == 1) & (dead > live * 1.15) & (dead > 0.45),
                       zero + 2, pred)
    pred = torch.where((pred == 2) & (live > dead * 1.15) & (live > 0.42),
                       zero + 1, pred)

    # noise floor
    pred = torch.where(max_prob < 0.3, zero, pred)

    # density-adaptive re-thresholding, per image
    n_px = pred.shape[-1] * pred.shape[-2]
    live_ratio = ((pred == 1).sum(dim=(-2, -1), dtype=torch.int32)
                  .to(torch.float32) / n_px)[..., None, None]
    dead_ratio = ((pred == 2).sum(dim=(-2, -1), dtype=torch.int32)
                  .to(torch.float32) / n_px)[..., None, None]

    live_high = (live > 0.5) & (live > bg * 1.3) & (bg < 0.3)
    pred = torch.where((live_ratio > 0.5) & (pred == 1) & ~live_high, zero, pred)

    severe, moderate = dead_ratio > 0.4, dead_ratio > 0.25
    thr = torch.where(severe, 0.65, torch.where(moderate, 0.6, 0.55))
    mult = torch.where(severe, 1.6, torch.where(moderate, 1.5, 1.4))
    bg_thr = torch.where(severe, 0.2, 0.25)
    live_guard = torch.where(severe, live < dead * 0.7,
                             torch.where(moderate, live < dead * 0.8, True))
    dead_high = (dead > thr) & (dead > bg * mult) & (bg < bg_thr) & live_guard
    pred = torch.where((dead_ratio > 0.15) & (pred == 2) & ~dead_high, zero, pred)
    return pred
