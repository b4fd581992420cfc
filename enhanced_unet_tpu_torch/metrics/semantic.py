"""Semantic segmentation metrics, ported from
`enhanced_unet_tpu/metrics/semantic.py`.

Per-class IoU and Dice all follow from one `num_classes x num_classes`
confusion matrix, `cm[gt, pred]` = pixel count (int64), built on the
tensors' device with one `torch.bincount` on `gt * C + pred`, so only the
C * C counts cross to the host.  The numpy functions keep the reference's
API and conventions.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

NUM_CLASSES = 3
CLASS_NAMES = ("background", "live", "dead")


def calculate_iou(mask1: np.ndarray, mask2: np.ndarray) -> float:
    """Binary IoU; an empty union gives 1.0."""
    intersection = np.logical_and(mask1, mask2).sum()
    union = np.logical_or(mask1, mask2).sum()
    if union == 0:
        return 1.0 if intersection == 0 else 0.0
    return float(intersection / union)


def calculate_dice(mask1: np.ndarray, mask2: np.ndarray) -> float:
    """Binary Dice; two empty masks give 1.0."""
    intersection = np.logical_and(mask1, mask2).sum()
    denom = mask1.sum() + mask2.sum()
    if denom == 0:
        return 1.0
    return float(2.0 * intersection / denom)


def calculate_semantic_metrics(pred_mask: np.ndarray, gt_mask: np.ndarray) -> Dict:
    """Per-class IoU/Dice and their means (0 background, 1 live, 2 dead)."""
    cm = semantic_confusion_matrix(torch.as_tensor(np.asarray(pred_mask)),
                                   torch.as_tensor(np.asarray(gt_mask)))
    return metrics_from_confusion(cm.numpy())


def semantic_confusion_matrix(pred_mask: torch.Tensor, gt_mask: torch.Tensor,
                              num_classes: int = NUM_CLASSES) -> torch.Tensor:
    """[C, C] int64 confusion matrix, cm[gt, pred] = pixel count."""
    idx = gt_mask.reshape(-1).long() * num_classes + pred_mask.reshape(-1).long()
    return torch.bincount(idx, minlength=num_classes * num_classes).reshape(
        num_classes, num_classes)


def batched_confusion_matrix(pred_masks: torch.Tensor, gt_masks: torch.Tensor,
                             num_classes: int = NUM_CLASSES) -> torch.Tensor:
    """[B, C, C] per-image confusion matrices from [B, H, W] masks, in one
    bincount on the masks' device."""
    b = pred_masks.shape[0]
    cc = num_classes * num_classes
    image = torch.arange(b, device=pred_masks.device)[:, None] * cc
    idx = (gt_masks.reshape(b, -1).long() * num_classes
           + pred_masks.reshape(b, -1).long() + image)
    return torch.bincount(idx.reshape(-1), minlength=b * cc).reshape(
        b, num_classes, num_classes)


def metrics_from_confusion(cm: np.ndarray) -> Dict:
    """The reference's metric dict from a confusion matrix: for class c,
    TP = cm[c, c], FP = column sum - TP, FN = row sum - TP; IoU =
    TP / (TP + FP + FN) and Dice = 2TP / (2TP + FP + FN), 1.0 when the
    denominator is 0.  `sem_mean_iou` leaves the background out."""
    cm = np.asarray(cm, dtype=np.float64)
    metrics: Dict = {}
    for c, name in enumerate(CLASS_NAMES):
        tp = cm[c, c]
        fp = cm[:, c].sum() - tp
        fn = cm[c, :].sum() - tp
        union = tp + fp + fn
        denom = 2 * tp + fp + fn
        metrics[f"sem_{name}_iou"] = float(1.0 if union == 0 else tp / union)
        metrics[f"sem_{name}_dice"] = float(1.0 if denom == 0 else 2 * tp / denom)
    metrics["sem_mean_iou"] = (metrics["sem_live_iou"] + metrics["sem_dead_iou"]) / 2
    metrics["sem_mean_iou_all"] = (metrics["sem_background_iou"] + metrics["sem_live_iou"]
                                   + metrics["sem_dead_iou"]) / 3
    metrics["sem_mean_dice"] = (metrics["sem_live_dice"] + metrics["sem_dead_dice"]) / 2
    return metrics
