"""Instance segmentation metrics, ported from
`enhanced_unet_tpu/metrics/instance.py`: greedy score-sorted matching.

Parity target: reference metrics.py:61-194 (calculate_instance_metrics).
The greedy semantics are kept exactly — predictions sorted by score
descending, each matched to the best unmatched GT by IoU, accepted at
IoU >= 0.05, with the reference's fallback of reporting the mean best-IoU of
all predictions when nothing matches, and the below-threshold diagnostic key.

Instance counts are small (<=500 per image, train_eval.py:842), so this is a
host-side numpy problem.  The pairwise-IoU inner loop is vectorized over
flattened masks instead of the reference's python double loop; with
`native=True` it runs on the native host ops (`enhanced_unet_tpu_torch.native`,
packed popcount; raises if they cannot be built), which give the same IoUs.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def _pairwise_iou(pred_masks: np.ndarray, gt_masks: np.ndarray,
                  native: bool = False) -> np.ndarray:
    """IoU matrix [n_pred, n_gt] over stacks of binary HxW masks: numpy
    matmul, or the native packed popcount with `native=True`."""
    if native:
        from enhanced_unet_tpu_torch import native as hostops

        iou = hostops.pairwise_iou(pred_masks, gt_masks)
        # reference convention (metrics.py:16-17): both empty -> IoU 1.0
        p_area = pred_masks.reshape(pred_masks.shape[0], -1).sum(axis=1)
        g_area = gt_masks.reshape(gt_masks.shape[0], -1).sum(axis=1)
        both_empty = (p_area[:, None] == 0) & (g_area[None, :] == 0)
        return np.where(both_empty, 1.0, iou)

    p = pred_masks.reshape(pred_masks.shape[0], -1).astype(bool)
    g = gt_masks.reshape(gt_masks.shape[0], -1).astype(bool)
    inter = p.astype(np.int64) @ g.astype(np.int64).T
    p_area = p.sum(axis=1, keepdims=True)
    g_area = g.sum(axis=1, keepdims=True).T
    union = p_area + g_area - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union > 0, inter / np.maximum(union, 1), 0.0)
    # reference convention (metrics.py:16-17): both empty -> IoU 1.0
    both_empty = (p_area == 0) & (g_area == 0)
    return np.where(both_empty, 1.0, iou)


def _match_class(
    preds: List, gts: List, iou_threshold: float, prefix: str, metrics: Dict,
    native: bool = False,
) -> None:
    """Greedy matching for one class; mutates `metrics` with the reference's
    key set (metrics.py:88-141)."""
    if not gts:
        return
    gt_stack = np.stack([np.asarray(m) for m in gts])

    matched_ious: List[float] = []
    all_pred_ious: List[float] = []
    if preds:
        pred_order = sorted(range(len(preds)), key=lambda i: preds[i][1], reverse=True)
        pred_stack = np.stack([np.asarray(preds[i][0]) for i in pred_order])
        iou_mat = _pairwise_iou(pred_stack, gt_stack, native)
        matched_gt = np.zeros(len(gts), dtype=bool)
        for row in iou_mat:
            masked = np.where(matched_gt, -1.0, row)
            best_gt = int(np.argmax(masked))
            best_iou = float(masked[best_gt])
            # reference greedy loop (metrics.py:92-107) only tracks strictly
            # positive best IoU (best_gt_idx stays -1 when all IoUs are 0)
            if best_iou <= 0.0:
                best_iou = 0.0
                best_gt = -1
            all_pred_ious.append(best_iou)
            if best_iou >= iou_threshold and best_gt >= 0:
                matched_ious.append(best_iou)
                matched_gt[best_gt] = True

    if matched_ious:
        metrics[f"{prefix}_iou"] = float(np.mean(matched_ious))
    elif all_pred_ious:
        # fallback: mean best-IoU of all predictions (metrics.py:109-117)
        metrics[f"{prefix}_iou"] = float(np.mean(all_pred_ious))
    else:
        metrics[f"{prefix}_iou"] = 0.0

    metrics[f"{prefix}_precision"] = (
        len(matched_ious) / len(preds) if preds else 0.0
    )
    metrics[f"{prefix}_recall"] = len(matched_ious) / len(gts) if gts else 0.0

    # diagnostic key for quality-but-unmatched predictions
    # (metrics.py:127-137)
    if (
        metrics[f"{prefix}_precision"] == 0.0
        and metrics[f"{prefix}_iou"] > 0.0
        and preds
    ):
        avg_below = float(np.mean(all_pred_ious)) if all_pred_ious else 0.0
        if avg_below >= 0.1:
            metrics[f"{prefix}_avg_iou_below_threshold"] = avg_below

    if preds:
        metrics[f"{prefix}_ap"] = (
            metrics[f"{prefix}_precision"] * metrics[f"{prefix}_recall"]
        )


def calculate_instance_metrics(
    pred_masks: Sequence[np.ndarray],
    pred_labels: Sequence[int],
    pred_scores: Sequence[float],
    gt_masks: Sequence[np.ndarray],
    gt_labels: Sequence[int],
    iou_threshold: float = 0.05,
    native: bool = False,
) -> Dict:
    """Per-class (live=0 / dead=1) precision, recall, matched-IoU and
    ap = precision * recall.  Key names match reference metrics.py:70-79."""
    metrics = {
        "live_iou": 0.0,
        "live_precision": 0.0,
        "live_recall": 0.0,
        "live_ap": 0.0,
        "dead_iou": 0.0,
        "dead_precision": 0.0,
        "dead_recall": 0.0,
        "dead_ap": 0.0,
    }

    pred_live = [
        (m, s) for m, l, s in zip(pred_masks, pred_labels, pred_scores) if l == 0
    ]
    pred_dead = [
        (m, s) for m, l, s in zip(pred_masks, pred_labels, pred_scores) if l == 1
    ]
    gt_live = [m for m, l in zip(gt_masks, gt_labels) if l == 0]
    gt_dead = [m for m, l in zip(gt_masks, gt_labels) if l == 1]

    _match_class(pred_live, gt_live, iou_threshold, "live", metrics, native)
    _match_class(pred_dead, gt_dead, iou_threshold, "dead", metrics, native)
    return metrics
