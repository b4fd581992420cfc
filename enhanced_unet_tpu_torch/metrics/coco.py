"""COCO mAP@[.5:.95] for bbox and segm, ported from
`enhanced_unet_tpu/metrics/coco.py`.

The reference (metrics.py:197-301, calculate_coco_metrics) assembles a
temporary COCO GT json and runs pycocotools' COCOeval, taking stats[0].
This module implements the COCOeval subset the reference exercises, without
pycocotools:

- categories live=0 / dead=1, area range 'all', maxDets=100
- IoU thresholds 0.50:0.05:0.95, 101-point interpolated AP
- greedy per-image matching in score order (COCOeval.evaluateImg semantics)
- categories with no GT excluded from the mean (AP == -1 convention)

Instance masks are small and few, so this is host-side numpy by design.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from enhanced_unet_tpu_torch.data.rle import decode_rle

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
MAX_DETS = 100
CATEGORY_IDS = (0, 1)  # live, dead (metrics.py:234-236)


def _bbox_iou_matrix(dt_boxes: np.ndarray, gt_boxes: np.ndarray) -> np.ndarray:
    """IoU over xywh boxes, [n_dt, n_gt] (maskApi bbIou semantics)."""
    if len(dt_boxes) == 0 or len(gt_boxes) == 0:
        return np.zeros((len(dt_boxes), len(gt_boxes)))
    dx0, dy0 = dt_boxes[:, 0:1], dt_boxes[:, 1:2]
    dx1, dy1 = dx0 + dt_boxes[:, 2:3], dy0 + dt_boxes[:, 3:4]
    gx0, gy0 = gt_boxes[:, 0], gt_boxes[:, 1]
    gx1, gy1 = gx0 + gt_boxes[:, 2], gy0 + gt_boxes[:, 3]
    iw = np.clip(np.minimum(dx1, gx1) - np.maximum(dx0, gx0), 0, None)
    ih = np.clip(np.minimum(dy1, gy1) - np.maximum(dy0, gy0), 0, None)
    inter = iw * ih
    da = (dt_boxes[:, 2] * dt_boxes[:, 3])[:, None]
    ga = gt_boxes[:, 2] * gt_boxes[:, 3]
    union = da + ga - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _segm_iou_matrix(dt_segs: List[Dict], gt_segs: List[Dict]) -> np.ndarray:
    """Mask IoU over RLE segmentations, [n_dt, n_gt]."""
    if not dt_segs or not gt_segs:
        return np.zeros((len(dt_segs), len(gt_segs)))
    dt = np.stack([decode_rle(s).reshape(-1).astype(bool) for s in dt_segs])
    gt = np.stack([decode_rle(s).reshape(-1).astype(bool) for s in gt_segs])
    inter = dt.astype(np.int64) @ gt.astype(np.int64).T
    da = dt.sum(axis=1, keepdims=True)
    ga = gt.sum(axis=1, keepdims=True).T
    union = da + ga - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(union > 0, inter / np.maximum(union, 1), 0.0)


def _evaluate_img(dts: List[Dict], gts: List[Dict], iou_mat: np.ndarray):
    """Greedy matching for one (image, category) pair across all IoU
    thresholds.  Returns (dt_matched[T, D], dt_scores[D], n_gt)."""
    T = len(IOU_THRS)
    D = len(dts)
    dtm = np.zeros((T, D), dtype=bool)
    if D and len(gts):
        gtm = np.zeros((T, len(gts)), dtype=bool)
        for ti, t in enumerate(IOU_THRS):
            for d in range(D):
                iou = min(t, 1 - 1e-10)
                best_g = -1
                for g in range(len(gts)):
                    if gtm[ti, g]:
                        continue
                    if iou_mat[d, g] < iou:
                        continue
                    iou = iou_mat[d, g]
                    best_g = g
                if best_g >= 0:
                    dtm[ti, d] = True
                    gtm[ti, best_g] = True
    scores = np.asarray([d.get("score", 0.0) for d in dts], dtype=np.float64)
    return dtm, scores, len(gts)


def _accumulate(per_image: List) -> float:
    """COCOeval.accumulate for one category: 101-point interpolated AP
    averaged over IoU thresholds; -1 when the category has no GT."""
    npig = sum(n_gt for _, _, n_gt in per_image)
    if npig == 0:
        return -1.0
    dtm = np.concatenate([m for m, _, _ in per_image], axis=1)
    scores = np.concatenate([s for _, s, _ in per_image])
    order = np.argsort(-scores, kind="mergesort")
    dtm = dtm[:, order]

    T = len(IOU_THRS)
    ap_per_t = np.zeros(T)
    for ti in range(T):
        tps = np.cumsum(dtm[ti]).astype(np.float64)
        fps = np.cumsum(~dtm[ti]).astype(np.float64)
        rc = tps / npig
        pr = tps / np.maximum(tps + fps, np.spacing(1))
        q = np.zeros(len(REC_THRS))
        # make precision monotonically decreasing from the right
        pr = pr.tolist()
        for i in range(len(pr) - 1, 0, -1):
            if pr[i] > pr[i - 1]:
                pr[i - 1] = pr[i]
        inds = np.searchsorted(rc, REC_THRS, side="left")
        for ri, pi in enumerate(inds):
            if pi < len(pr):
                q[ri] = pr[pi]
        ap_per_t[ti] = np.mean(q)
    return float(np.mean(ap_per_t))


def _map_for_type(
    pred_annotations: Sequence[Dict],
    gt_annotations: Sequence[Dict],
    iou_type: str,
) -> float:
    image_ids = sorted(
        {a.get("image_id", 1) for a in gt_annotations}
        | {a.get("image_id", 1) for a in pred_annotations}
    )
    aps = []
    for cat in CATEGORY_IDS:
        per_image = []
        for img in image_ids:
            dts = [
                a
                for a in pred_annotations
                if a.get("image_id", 1) == img and int(a.get("category_id", 0)) == cat
            ]
            gts = [
                a
                for a in gt_annotations
                if a.get("image_id", 1) == img and int(a.get("category_id", 0)) == cat
            ]
            dts = sorted(dts, key=lambda a: -a.get("score", 0.0))[:MAX_DETS]
            if iou_type == "bbox":
                iou_mat = _bbox_iou_matrix(
                    np.asarray([d["bbox"] for d in dts], dtype=np.float64).reshape(
                        len(dts), 4
                    ),
                    np.asarray([g["bbox"] for g in gts], dtype=np.float64).reshape(
                        len(gts), 4
                    ),
                )
            else:
                iou_mat = _segm_iou_matrix(
                    [d["segmentation"] for d in dts],
                    [g["segmentation"] for g in gts],
                )
            per_image.append(_evaluate_img(dts, gts, iou_mat))
        ap = _accumulate(per_image)
        if ap > -1:
            aps.append(ap)
    return float(np.mean(aps)) if aps else 0.0


def calculate_coco_metrics(
    pred_annotations: Sequence[Dict], gt_annotations: Sequence[Dict]
) -> Dict:
    """{'bbox_mAP', 'segm_mAP'} — stats[0] of COCOeval for each iou type.

    Same zeroed fallback as the reference when either side is empty
    (metrics.py:202-205).
    """
    metrics = {"bbox_mAP": 0.0, "segm_mAP": 0.0}
    if not pred_annotations or not gt_annotations:
        return metrics
    try:
        metrics["bbox_mAP"] = _map_for_type(pred_annotations, gt_annotations, "bbox")
        metrics["segm_mAP"] = _map_for_type(pred_annotations, gt_annotations, "segm")
    except Exception as e:  # mirror reference resilience (metrics.py:296-300)
        print(f"Error calculating COCO metrics: {e}")
        import traceback

        traceback.print_exc()
    return metrics
