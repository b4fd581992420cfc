"""Training losses, ported from `enhanced_unet_tpu/ops/losses.py`.

Focal (class-weighted CE inside), soft Dice and Tversky, their weighted
sum, and the flagship's deep supervision with the consistency term.  The
public API takes NHWC logits and `[B, H, W]` integer targets; each loss casts
the logits to fp32 and works channel-first on `[B, C, H*W]` planes, with
per-class {0, 1} masks in place of gathers (C = 3).  An optional `valid_mask`
`[B, H, W]` leaves padded pixels out; an all-ones mask gives the unmasked
result.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from enhanced_unet_tpu_torch.config import LossConfig


def _to_cf(logits: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> channel-first [B, C, P] fp32 (P = H*W)."""
    b, h, w, c = logits.shape
    return logits.float().permute(0, 3, 1, 2).reshape(b, c, h * w)


def _flat(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """[B, H, W] -> [B, P] fp32, or None."""
    return None if x is None else x.reshape(x.shape[0], -1).float()


def _class_masks(targets: torch.Tensor, num_classes: int):
    tgt = targets.reshape(targets.shape[0], -1)
    return [(tgt == c).float() for c in range(num_classes)]


def _focal_cf(logp, masks, alpha, gamma, class_weights, valid, focal_norm=None):
    """Class-weighted focal cross-entropy.  The CE is weighted before
    pt = exp(-ce), so pt depends on the class weight, as the reference's
    `F.cross_entropy(weight=..., reduction='none')` makes it.  `focal_norm`,
    when given, divides the valid pixels' sum in place of their count."""
    c = logp.shape[1]
    nll = sum(-logp[:, i] * masks[i] for i in range(c))
    wmap = sum(class_weights[i] * masks[i] for i in range(c))
    amap = sum(alpha[i] * masks[i] for i in range(c))
    ce = wmap * nll
    focal = amap * (1.0 - torch.exp(-ce)) ** gamma * ce
    if valid is None:
        return focal.mean()
    norm = valid.sum().clamp_min(1.0) if focal_norm is None else focal_norm
    return (focal * valid).sum() / norm


def _overlap_terms_cf(probs, masks, valid):
    """Per-sample, per-class (tp, fp, fn) sums, each [B, C]."""
    tps, fps, fns = [], [], []
    for i in range(probs.shape[1]):
        p, m = probs[:, i], masks[i]
        if valid is not None:
            p, m = p * valid, m * valid
        pm = (p * m).sum(1)
        tps.append(pm)
        fps.append(p.sum(1) - pm)
        fns.append(m.sum(1) - pm)
    return torch.stack(tps, 1), torch.stack(fps, 1), torch.stack(fns, 1)


def _weights(class_weights: Sequence[float], like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(class_weights, dtype=torch.float32, device=like.device)


def _dice_from_terms(tp, fp, fn, class_weights, eps):
    """Weighted soft Dice: per sample and class, weighted, mean over the
    batch, then over the classes."""
    dice = (2.0 * tp + eps) / (2.0 * tp + fp + fn + eps)
    return ((1.0 - dice) * _weights(class_weights, tp)).mean(0).mean()


def _tversky_from_terms(tp, fp, fn, class_weights, alpha, eps):
    tversky = (tp + eps) / (tp + alpha * fp + (1.0 - alpha) * fn + eps)
    return ((1.0 - tversky) * _weights(class_weights, tp)).mean(0).mean()


def focal_loss(logits: torch.Tensor, targets: torch.Tensor,
               alpha: Sequence[float], gamma: float,
               class_weights: Sequence[float],
               valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    lcf = _to_cf(logits)
    return _focal_cf(torch.log_softmax(lcf, 1), _class_masks(targets, lcf.shape[1]),
                     alpha, gamma, class_weights, _flat(valid_mask))


def dice_loss(logits: torch.Tensor, targets: torch.Tensor,
              class_weights: Sequence[float], eps: float = 1e-6,
              valid_mask: Optional[torch.Tensor] = None,
              probs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`probs`, when given, is the NHWC softmax of the logits."""
    pcf = _to_cf(probs) if probs is not None else torch.softmax(_to_cf(logits), 1)
    terms = _overlap_terms_cf(pcf, _class_masks(targets, pcf.shape[1]),
                              _flat(valid_mask))
    return _dice_from_terms(*terms, class_weights, eps)


def tversky_loss(logits: torch.Tensor, targets: torch.Tensor,
                 class_weights: Sequence[float], alpha: float = 0.7,
                 eps: float = 1e-6, valid_mask: Optional[torch.Tensor] = None,
                 probs: Optional[torch.Tensor] = None) -> torch.Tensor:
    pcf = _to_cf(probs) if probs is not None else torch.softmax(_to_cf(logits), 1)
    terms = _overlap_terms_cf(pcf, _class_masks(targets, pcf.shape[1]),
                              _flat(valid_mask))
    return _tversky_from_terms(*terms, class_weights, alpha, eps)


def _combined_loss_cf(lcf, targets, cfg: LossConfig, valid_mask, focal_norm=None):
    masks = _class_masks(targets, lcf.shape[1])
    valid = _flat(valid_mask)
    logp = torch.log_softmax(lcf, 1)
    f = _focal_cf(logp, masks, cfg.focal_alpha, cfg.focal_gamma,
                  cfg.ce_class_weights, valid, focal_norm)
    tp, fp, fn = _overlap_terms_cf(torch.exp(logp), masks, valid)
    d = _dice_from_terms(tp, fp, fn, cfg.dice_class_weights, cfg.eps)
    t = _tversky_from_terms(tp, fp, fn, cfg.tversky_class_weights,
                            cfg.tversky_alpha, cfg.eps)
    return cfg.focal_weight * f + cfg.dice_weight * d + cfg.tversky_weight * t


def combined_loss(logits: torch.Tensor, targets: torch.Tensor, cfg: LossConfig,
                  valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """focal_weight * focal + dice_weight * dice + tversky_weight * tversky,
    with one softmax shared by the three."""
    return _combined_loss_cf(_to_cf(logits), targets, cfg, valid_mask)


def combined_loss_with_aux(logits: torch.Tensor, aux_logits: Dict[str, torch.Tensor],
                           targets: torch.Tensor, cfg: LossConfig,
                           valid_mask: Optional[torch.Tensor] = None,
                           focal_norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The combined loss on the fused logits, plus, for each aux branch of
    `cfg.aux_branch_weights` present in `aux_logits` (at the targets'
    resolution), its weighted combined loss and the weighted consistency
    term: the mean over all elements, padded pixels included, of the squared
    difference between the branch's and the fused softmax.  `focal_norm`
    (with `valid_mask`) divides each focal term's sum over the valid pixels
    in place of their count: a shard of a batch split over ranks passes the
    whole batch's count over the number of shards."""
    lcf = _to_cf(logits)
    total = _combined_loss_cf(lcf, targets, cfg, valid_mask, focal_norm)
    fused_probs = torch.softmax(lcf, 1) if cfg.consistency_weight > 0 else None
    for name, weight in cfg.aux_branch_weights:
        branch = aux_logits.get(name)
        if branch is None:
            continue
        bcf = _to_cf(branch)
        total = total + weight * _combined_loss_cf(bcf, targets, cfg, valid_mask, focal_norm)
        if fused_probs is not None:
            consistency = ((torch.softmax(bcf, 1) - fused_probs) ** 2).mean()
            total = total + weight * cfg.consistency_weight * consistency
    return total
