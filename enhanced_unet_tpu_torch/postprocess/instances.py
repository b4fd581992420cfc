"""Semantic mask -> instance masks, ported from
`enhanced_unet_tpu/postprocess/instances.py` (the reference's
`semantic_to_instances`, train_eval.py:654-850), rule for rule:

- per class (live = 1, dead = 2): a 2x2-ellipse morphological opening;
- connected components (8-connectivity, `scipy.ndimage.label`);
- regions of 200 px or more: erosion (3x3 ellipse, 2-8 iterations by area)
  to split touching cells, dilated back and clipped to the region, a
  one-level re-split of pieces still over 200 px; else a small-kernel pass,
  then a 5x5 one;
- per-class area gates (live 3..1500 px, dead 5..1500 px);
- confidence = 0.7 * min(area / 150, 1) + 0.3 * compactness (4 pi A / P^2);
- at most 500 instances, by confidence.

The JAX package runs this with OpenCV.  The port does not import it: it
computes OpenCV's results itself with numpy and scipy, which the tests hold
against OpenCV directly:

- `cv2.getStructuringElement(MORPH_ELLIPSE, ...)` for sizes 2, 3 and 5 (the
  2x2 ellipse is [[0, 1], [1, 1]], not a square);
- `cv2.erode` / `cv2.dilate` / `MORPH_OPEN`: the anchor at (size // 2,
  size // 2), the kernel used unreflected by both (dst(p) = min / max of
  src(p + k - anchor)), pixels outside the image counting as foreground
  for an erosion and as background for a dilation, iterations applied one
  after another;
- `cv2.findContours(RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)`: the image framed
  by one pixel of background; the outer border of each 8-connected
  component not inside a hole of another, followed from its first pixel in
  raster order as Suzuki and Abe's algorithm does in OpenCV, with runs of
  one direction reduced to their end points; the list comes back in reverse
  raster order of the borders' first pixels, so `contours[0]` is the border
  found last;
- `cv2.arcLength(closed=True)`: float32 segment lengths summed in double,
  from the closing segment on.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
from scipy import ndimage

_EIGHT = np.ones((3, 3), dtype=np.int32)    # 8-connectivity
_FOUR = ndimage.generate_binary_structure(2, 1)

# cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (size, size))
_ELLIPSES = {
    2: np.array([[0, 1], [1, 1]], np.uint8),
    3: np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], np.uint8),
    5: np.array([[0, 0, 1, 0, 0],
                 [1, 1, 1, 1, 1],
                 [1, 1, 1, 1, 1],
                 [1, 1, 1, 1, 1],
                 [0, 0, 1, 0, 0]], np.uint8),
}

# Freeman codes of OpenCV's contour tracer as (dy, dx): 0 right, 1 up-right,
# 2 up, ... counterclockwise on the screen
_STEPS = ((0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1), (1, -1), (1, 0), (1, 1))

LARGE_REGION = 200


def ellipse(size: int) -> np.ndarray:
    """`cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (size, size))` for the
    sizes this module uses (2, 3, 5)."""
    return _ELLIPSES[size].copy()


def _morph(mask: np.ndarray, kernel: np.ndarray, iterations: int,
           erode: bool) -> np.ndarray:
    """OpenCV's erosion (min) or dilation (max) over the unreflected
    `kernel` anchored at its centre, `iterations` times, the border taken
    as foreground for an erosion and background for a dilation."""
    h, w = mask.shape
    ay, ax = kernel.shape[0] // 2, kernel.shape[1] // 2
    offsets = [(int(y) - ay, int(x) - ax) for y, x in np.argwhere(kernel)]
    r = max(max(abs(dy), abs(dx)) for dy, dx in offsets)
    out = np.asarray(mask) > 0
    for _ in range(iterations):
        padded = np.pad(out, r, constant_values=erode)
        acc = None
        for dy, dx in offsets:
            view = padded[r + dy: r + dy + h, r + dx: r + dx + w]
            if acc is None:
                acc = view.copy()
            elif erode:
                acc &= view
            else:
                acc |= view
        out = acc
    return out.astype(np.uint8)


def erode(mask: np.ndarray, kernel: np.ndarray, iterations: int = 1) -> np.ndarray:
    """`cv2.erode(mask, kernel, iterations=iterations)` on a binary mask."""
    return _morph(mask, kernel, iterations, erode=True)


def dilate(mask: np.ndarray, kernel: np.ndarray, iterations: int = 1) -> np.ndarray:
    """`cv2.dilate(mask, kernel, iterations=iterations)` on a binary mask."""
    return _morph(mask, kernel, iterations, erode=False)


def morph_open(mask: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """`cv2.morphologyEx(mask, cv2.MORPH_OPEN, kernel)`: the erosion, then
    the dilation with the same unreflected kernel and anchor."""
    return dilate(erode(mask, kernel), kernel)


def _label(mask: np.ndarray) -> Tuple[np.ndarray, int]:
    """8-connective labelling (== skimage.measure.label(connectivity=2))."""
    return ndimage.label(mask, structure=_EIGHT)


def _follow_border(img: np.ndarray, y0: int, x0: int) -> List[Tuple[int, int]]:
    """The outer border that starts at (y0, x0) of the framed 0/1 image
    `img`, traced as OpenCV's `icvFetchContour` does, as CHAIN_APPROX_SIMPLE
    vertices (x, y): a point is kept where the direction changes."""
    s = s_end = 4
    while True:     # clockwise from the left neighbour to the border's last pixel
        s = (s - 1) & 7
        y1, x1 = y0 + _STEPS[s][0], x0 + _STEPS[s][1]
        if img[y1, x1] or s == s_end:
            break
    if s == s_end:  # a lone pixel
        return [(x0, y0)]
    points = []
    y3, x3 = y0, x0
    px, py = x0, y0
    prev_s = s ^ 4
    while True:
        s_end = s
        while s < 15:       # counterclockwise from the pixel it came from
            s += 1
            y4, x4 = y3 + _STEPS[s & 7][0], x3 + _STEPS[s & 7][1]
            if img[y4, x4]:
                break
        s &= 7
        if s != prev_s:
            points.append((px, py))
            prev_s = s
        px, py = px + _STEPS[s][1], py + _STEPS[s][0]
        if (y4, x4) == (y0, x0) and (y3, x3) == (y1, x1):
            return points
        y3, x3 = y4, x4
        s = (s + 4) & 7


def external_contours(mask: np.ndarray) -> List[List[Tuple[int, int]]]:
    """`cv2.findContours(mask, cv2.RETR_EXTERNAL,
    cv2.CHAIN_APPROX_SIMPLE)[0]` as lists of (x, y) vertices, in OpenCV's
    order (reverse raster order of the borders' first pixels)."""
    img = np.pad(np.asarray(mask) > 0, 1).astype(np.uint8)
    comps, n = _label(img)
    if n == 0:
        return []
    background, _ = ndimage.label(img == 0, structure=_FOUR)
    flat = comps.ravel()
    nz = np.flatnonzero(flat)
    labels, first = np.unique(flat[nz], return_index=True)
    starts = sorted(int(nz[i]) for i in first)
    w = img.shape[1]
    out = []
    for start in reversed(starts):
        y, x = divmod(start, w)
        # outer border of a component in the frame's background, not in a hole
        if background[y, x - 1] == background[0, 0]:
            out.append([(px - 1, py - 1) for px, py in _follow_border(img, y, x)])
    return out


def arc_length_closed(points: Sequence[Tuple[int, int]]) -> float:
    """`cv2.arcLength(points, closed=True)`: float32 segment lengths,
    summed in double from the closing segment on."""
    if len(points) <= 1:
        return 0.0
    pts = np.asarray(points, np.float32)
    d = pts - np.roll(pts, 1, axis=0)
    seg = np.sqrt((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]).astype(np.float32))
    perimeter = 0.0
    for v in seg.tolist():
        perimeter += v
    return perimeter


def _compactness(mask: np.ndarray, area: float) -> float:
    """4 pi A / P^2 with P the length of `contours[0]` of the external
    contours; 0.5 when there is no contour or it has no length
    (train_eval.py:818-829)."""
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return 0.5
    # the contours of the bounding box are those of the image, moved
    crop = mask[ys.min(): ys.max() + 1, xs.min(): xs.max() + 1]
    contours = external_contours(crop)
    perimeter = arc_length_closed(contours[0]) if contours else 0.0
    if perimeter > 0:
        return float(4 * np.pi * area / (perimeter ** 2))
    return 0.5


def semantic_to_instances(
    semantic_mask: np.ndarray, min_area: int = 3
) -> Tuple[List[np.ndarray], List[int], List[float]]:
    """Split each class's connected regions into individual cell instances.

    Returns (instance masks [H, W] uint8, labels [0 = live, 1 = dead],
    scores)."""
    instance_masks: List[np.ndarray] = []
    instance_labels: List[int] = []
    instance_scores: List[float] = []
    k3 = ellipse(3)
    semantic_mask = np.asarray(semantic_mask)

    for class_id in (1, 2):
        class_mask = (semantic_mask == class_id).astype(np.uint8)
        if class_mask.sum() == 0:
            continue
        class_mask = morph_open(class_mask, ellipse(2))
        markers, num_labels = _label(class_mask)
        final_markers = np.zeros_like(markers, dtype=np.int32)
        next_label = [1]

        def emit(region: np.ndarray) -> None:
            if region.sum() >= min_area:
                final_markers[region > 0] = next_label[0]
                next_label[0] += 1

        def split(pieces: np.ndarray, n: int, kernel: np.ndarray, iters: int,
                  within: np.ndarray, resplit: bool = False) -> None:
            for label_id in range(1, n + 1):
                grown = dilate((pieces == label_id).astype(np.uint8), kernel,
                               iters) & within
                if resplit and grown.sum() > LARGE_REGION:
                    # one-level re-split (train_eval.py:716-735)
                    sub, n2 = _label(erode(grown, k3, 2))
                    if n2 > 1:
                        split(sub, n2, k3, 2, grown)
                        continue
                emit(grown)

        for label_id in range(1, num_labels + 1):
            region = (markers == label_id).astype(np.uint8)
            area = int(region.sum())
            if area < LARGE_REGION:
                emit(region)
                continue
            # aggressive erosion split (train_eval.py:697-740)
            iters = max(2, min(area // 1000, 8))
            sub, n = _label(erode(region, k3, iters))
            if n > 1:
                split(sub, n, k3, iters, region, resplit=True)
                continue
            # incremental small-kernel erosion, up to 3 passes
            # (train_eval.py:744-763), then the 5x5 kernel (:766-785)
            eroded = region
            for _ in range(3):
                eroded = erode(eroded, k3, 1)
                sub, n = _label(eroded)
                if n > 1:
                    split(sub, n, k3, 3, region)
                    break
            else:
                k5 = ellipse(5)
                sub, n = _label(erode(region, k5, 3))
                if n > 1:
                    split(sub, n, k5, 3, region)
                else:
                    emit(region)

        # area gates + confidence (train_eval.py:790-838)
        min_thr = max(3 if class_id == 1 else 5, min_area)
        for label_id in range(1, int(final_markers.max()) + 1):
            inst = (final_markers == label_id).astype(np.uint8)
            area = int(inst.sum())
            if area < min_thr or area > 1500:
                continue
            confidence = 0.7 * min(area / 150.0, 1.0) + 0.3 * _compactness(inst, area)
            instance_masks.append(inst)
            instance_labels.append(class_id - 1)
            instance_scores.append(confidence)

        # at most 500 by confidence (train_eval.py:842-848), inside the
        # class loop over the combined lists, as the reference does
        if len(instance_masks) > 500:
            order = sorted(range(len(instance_scores)),
                           key=lambda i: instance_scores[i], reverse=True)[:500]
            instance_masks = [instance_masks[i] for i in order]
            instance_labels = [instance_labels[i] for i in order]
            instance_scores = [instance_scores[i] for i in order]

    return instance_masks, instance_labels, instance_scores


__all__ = ["semantic_to_instances", "erode", "dilate", "morph_open", "ellipse",
           "external_contours", "arc_length_closed"]
