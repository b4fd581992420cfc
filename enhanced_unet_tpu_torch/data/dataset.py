"""Host-side dataset, ported from `enhanced_unet_tpu/data/dataset.py`: list
the `*.jpg` files, split them 70/15/15 by sorted name, decode, resize with
/32 snapping, and rasterise the labelme polygons into instance masks and a
semantic mask.

The JAX package rasterises with `cv2.fillPoly` and resizes with
`cv2.resize(INTER_LINEAR)` when OpenCV imports.  This module imports no
`cv2` and computes the same pixels with numpy:

- `_fill_polygon` is OpenCV's `fillPoly` for one integer polygon: every
  edge drawn as an 8-connected line (OpenCV's `LineIterator`, its
  left-to-right order and its clipping), then the even-odd fill of the rows
  the polygon spans, from ceil(left x) to floor(right x), each edge's x
  stepped in 16.16 fixed point (an edge that leaves the image takes the x
  of its clipped ends).  This rule was found by holding candidate rules
  against OpenCV 5.0 on random polygons, in and past the image;
- `_resize_image` is OpenCV's bilinear downscale of uint8 images: source
  coordinates in float32, 11-bit coefficients, a horizontal pass in
  integers and the vertical pass of its SIMD path.

Both are held against OpenCV itself in the tests.  Decoding goes through
Pillow (`Image.open(path).convert("RGB")`, as in the JAX package), imported
when the first image is read.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from enhanced_unet_tpu_torch.data.rle import encode_rle

_XY_SHIFT = 16              # OpenCV's fixed point for polygon edges
_XY_ONE = 1 << _XY_SHIFT
_COEF_SCALE = 2048          # OpenCV's INTER_RESIZE_COEF_SCALE (11 bits)


def _tdiv(a: int, b: int) -> int:
    """C's integer division, which truncates toward zero."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's `clipLine` (Cohen-Sutherland on the image rectangle, each
    intersection truncated toward zero, the second end computed from the
    first end's already clipped coordinates).  Returns (inside, x1, y1, x2,
    y2)."""
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _line_pixels(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """The pixels (ys, xs) of OpenCV's 8-connected `LineIterator` from
    (x1, y1) to (x2, y2), left to right, clipped to the image."""
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        inside, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, abs(y2 - y1)
    sy = -1 if y2 < y1 else 1
    vert = dy > dx
    major, minor = (dy, dx) if vert else (dx, dy)
    k = np.arange(major + 1, dtype=np.int64)
    # step k moves the minor coordinate when the error term went negative:
    # after k steps it has moved ceil((2 minor k - major) / (2 major)) times
    m = -((major - 2 * minor * k) // (2 * major)) if major else k
    if vert:
        return y1 + sy * k, x1 + m
    return y1 + sy * m, x1 + k


def _fill_polygon(mask: np.ndarray, points: np.ndarray) -> None:
    """Rasterise one integer polygon [N, 2] (x, y) into `mask` with 1, as
    `cv2.fillPoly(mask, [points], 1)` does."""
    h, w = mask.shape
    pts = np.asarray(points, np.int64).reshape(-1, 2)
    n = len(pts)
    edges = []                      # (y0, y1, x at y0, dx), 16.16 fixed point
    x0, y0 = (int(v) for v in pts[n - 1])
    for i in range(n):
        x1, y1 = (int(v) for v in pts[i])
        ys, xs = _line_pixels(w, h, x0, y0, x1, y1)
        mask[ys, xs] = 1
        if y0 != y1:
            py0, py1 = y0, y1
            if 0 <= x0 < w and 0 <= x1 < w and 0 <= y0 < h and 0 <= y1 < h:
                px0, px1 = x0, x1
            else:
                # an edge that leaves the image runs through the x of its
                # clipped ends, at their rows when they differ
                _, px0, cy0, px1, cy1 = _clip_line(w, h, x0, y0, x1, y1)
                if cy0 != cy1:
                    py0, py1 = cy0, cy1
            px0, px1 = px0 << _XY_SHIFT, px1 << _XY_SHIFT
            dx = _tdiv(px1 - px0, py1 - py0)
            if y0 < y1:
                edges.append((y0, y1, px0 + (y0 - py0) * dx, dx))
            else:
                edges.append((y1, y0, px1 + (y1 - py1) * dx, dx))
        x0, y0 = x1, y1
    if len(edges) < 2:
        return
    e = np.asarray(edges, np.int64)
    ey0, ey1, ex, edx = e.T
    ex1 = ex + (ey1 - ey0) * edx
    if (ey1.max() < 0 or ey0.min() >= h or max(ex.max(), ex1.max()) < 0
            or min(ex.min(), ex1.min()) >= (w << _XY_SHIFT)):
        return
    rows = np.arange(max(int(ey0.min()), 0), min(int(ey1.max()), h), dtype=np.int64)
    if not len(rows):
        return
    # the active edges' x on each row, sorted; consecutive pairs bound spans
    active = (ey0[None] <= rows[:, None]) & (rows[:, None] < ey1[None])
    xs = np.where(active, ex[None] + (rows[:, None] - ey0[None]) * edx[None],
                  np.iinfo(np.int64).max)
    xs = np.sort(xs, axis=1)
    count = active.sum(axis=1)
    for j in range(0, int(count.max()) - 1, 2):
        ok = j + 1 < count
        lo, hi = (xs[ok, j] + _XY_ONE - 1) >> _XY_SHIFT, xs[ok, j + 1] >> _XY_SHIFT
        r = rows[ok]
        keep = (lo < w) & (hi >= 0)
        lo, hi, r = np.maximum(lo[keep], 0), np.minimum(hi[keep], w - 1), r[keep]
        for y, a, b in zip(r.tolist(), lo.tolist(), hi.tolist()):
            mask[y, a:b + 1] = 1


def _resize_taps(dst: int, src: int):
    """OpenCV's bilinear taps along one axis: source indices (first,
    second) and 11-bit weights (c0, c1) with c0 + c1 = 2048."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    low, high = s < 0, s >= src - 1
    f[low | high] = 0.0
    s = np.clip(s, 0, src - 1)
    c0 = np.rint((np.float32(1.0) - f) * np.float32(_COEF_SCALE)).astype(np.int32)
    return s, np.minimum(s + 1, src - 1), c0, _COEF_SCALE - c0


def _resize_image(image: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """`cv2.resize(image, size_wh, interpolation=INTER_LINEAR)` of a uint8
    [H, W, C] image, for the downscales the dataset makes."""
    dw, dh = size_wh
    h, w = image.shape[:2]
    x0, x1, a0, a1 = _resize_taps(dw, w)
    y0, y1, b0, b1 = _resize_taps(dh, h)
    rows = np.unique(np.concatenate([y0, y1]))
    pos = np.searchsorted(rows, np.stack([y0, y1]))
    src = image[rows]
    hz = (src[:, x0].astype(np.int32) * a0[None, :, None]
          + src[:, x1].astype(np.int32) * a1[None, :, None]) >> 4
    r0, r1 = hz[pos[0]], hz[pos[1]]
    out = (((b0[:, None, None] * r0) >> 16) + ((b1[:, None, None] * r1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def _read_rgb(path: str) -> np.ndarray:
    """Decode an image file to uint8 RGB [H, W, 3] with Pillow."""
    try:
        from PIL import Image
    except ImportError as err:
        raise ImportError(f"reading {path} needs Pillow, which is not installed") from err
    with Image.open(path) as im:
        return np.array(im.convert("RGB"))


def snap_to_multiple(h: int, w: int, max_size: int, multiple: int = 32) -> Tuple[int, int]:
    """Scale so the longer side is at most `max_size`, then floor-snap both
    sides to a multiple of `multiple`."""
    if max(h, w) > max_size:
        scale = max_size / max(h, w)
        h, w = int(h * scale), int(w * scale)
    return (h // multiple) * multiple, (w // multiple) * multiple


class CellDataset:
    """Bright-field microscopy cells with labelme-style JSON polygons.

    Items hold `image` (float32 [H, W, 3] in [0, 1]), `image_u8`,
    `instance_masks`, `instance_labels` (0 live, 1 dead), `bboxes`,
    `semantic_mask` (0 background, 1 live, 2 dead), `image_id` and
    `original_size`.  The train-time preprocess and augmentation are not
    applied here: the loader runs them on the device."""

    def __init__(self, data_dir: str, split: str = "train", max_size: int = 1024,
                 files: Optional[Sequence[str]] = None):
        self.data_dir = data_dir
        self.split = split
        self.max_size = max_size
        if files is not None:
            self.files = list(files)
        else:
            all_files = sorted(f for f in os.listdir(data_dir) if f.endswith(".jpg"))
            n_total = len(all_files)
            n_train = int(n_total * 0.7)
            n_val = int(n_total * 0.15)
            if split == "train":
                self.files = all_files[:n_train]
            elif split == "val":
                self.files = all_files[n_train:n_train + n_val]
            else:
                self.files = all_files[n_train + n_val:]

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> Dict:
        img_name = self.files[idx]
        json_path = os.path.join(self.data_dir, img_name.replace(".jpg", ".json"))
        image = _read_rgb(os.path.join(self.data_dir, img_name))
        original_size = image.shape[:2]

        h, w = snap_to_multiple(*original_size, self.max_size)
        if (h, w) != original_size:
            image = _resize_image(image, (w, h))

        annotations = {}
        if os.path.exists(json_path):
            with open(json_path, "r", encoding="utf-8") as f:
                annotations = json.load(f)

        scale_h = h / original_size[0]
        scale_w = w / original_size[1]
        instance_masks: List[np.ndarray] = []
        instance_labels: List[int] = []
        bboxes: List[List[int]] = []
        for shape in annotations.get("shapes", []):
            label = shape["label"].lower()
            if label not in ("live", "dead"):
                continue
            points = np.asarray(shape["points"], dtype=np.float32)
            points[:, 0] *= scale_w
            points[:, 1] *= scale_h
            points = points.astype(np.int32)

            mask = np.zeros((h, w), dtype=np.uint8)
            _fill_polygon(mask, points)
            x_min, y_min = points.min(axis=0)
            x_max, y_max = points.max(axis=0)
            instance_masks.append(mask)
            instance_labels.append(0 if label == "live" else 1)
            bboxes.append([int(x_min), int(y_min), int(x_max), int(y_max)])

        semantic_mask = np.zeros((h, w), dtype=np.int32)
        for mask, label in zip(instance_masks, instance_labels):
            semantic_mask[mask > 0] = label + 1

        return {
            "image": image.astype(np.float32) / 255.0,
            "image_u8": image,
            "instance_masks": instance_masks,
            "instance_labels": instance_labels,
            "bboxes": bboxes,
            "semantic_mask": semantic_mask,
            "image_id": img_name,
            "original_size": original_size,
        }

    def get_coco_format(self, idx: int) -> Dict:
        """COCO-format annotations of one item."""
        item = self.__getitem__(idx)
        coco_annotations = [
            {"id": i, "category_id": label, "bbox": bbox, "segmentation": encode_rle(mask),
             "area": int(mask.sum()), "iscrowd": 0}
            for i, (mask, label, bbox) in enumerate(
                zip(item["instance_masks"], item["instance_labels"], item["bboxes"]))]
        return {"image": item["image"], "annotations": coco_annotations,
                "image_id": item["image_id"], "original_size": item["original_size"]}


def collate_fn(batch: List[Dict], pad_shape: Optional[Tuple[int, int]] = None) -> Dict:
    """Fixed-shape batching: images and semantic masks zero-padded to
    `pad_shape` (or the batch's largest sides, rounded up to /32), a
    `valid_mask` of the real pixels, and the items themselves in
    `batch_items`."""
    if pad_shape is None:
        max_h = max(item["image"].shape[0] for item in batch)
        max_w = max(item["image"].shape[1] for item in batch)
        pad_shape = (-(-max_h // 32) * 32, -(-max_w // 32) * 32)
    ph, pw = pad_shape
    images = np.zeros((len(batch), ph, pw, 3), dtype=np.float32)
    masks = np.zeros((len(batch), ph, pw), dtype=np.int32)
    valid = np.zeros((len(batch), ph, pw), dtype=bool)
    for i, item in enumerate(batch):
        h, w = item["image"].shape[:2]
        images[i, :h, :w] = item["image"]
        masks[i, :h, :w] = item["semantic_mask"]
        valid[i, :h, :w] = True
    return {"images": images, "semantic_masks": masks, "valid_mask": valid,
            "batch_items": batch}
