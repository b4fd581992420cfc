"""Cell-viability metrics, ported from `enhanced_unet_tpu/metrics/viability.py`
(reference metrics.py:304-340)."""

from __future__ import annotations

from typing import Dict


def calculate_viability_metrics(
    pred_live_count: int,
    pred_dead_count: int,
    gt_live_count: int,
    gt_dead_count: int,
) -> Dict:
    """viability = live/(live+dead); accuracy = 1 - |pred - gt| clamped."""
    pred_total = pred_live_count + pred_dead_count
    gt_total = gt_live_count + gt_dead_count

    pred_viability = pred_live_count / pred_total if pred_total > 0 else 0.0
    gt_viability = gt_live_count / gt_total if gt_total > 0 else 0.0

    if gt_total > 0:
        viability_error = abs(pred_viability - gt_viability)
        viability_accuracy = 1.0 - min(viability_error, 1.0)
    else:
        viability_accuracy = 1.0 if pred_total == 0 else 0.0

    return {
        "pred_viability": pred_viability,
        "gt_viability": gt_viability,
        "viability_accuracy": viability_accuracy,
        "pred_live_count": pred_live_count,
        "pred_dead_count": pred_dead_count,
        "gt_live_count": gt_live_count,
        "gt_dead_count": gt_dead_count,
    }
