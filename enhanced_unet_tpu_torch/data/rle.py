"""COCO run-length encoding, ported from `enhanced_unet_tpu/data/rle.py`:
column-major (Fortran) run lengths and pycocotools' string compression
(maskApi.c rleToString / rleFrString), bit-compatible with
`pycocotools.mask.encode`.

Run extraction is a numpy diff; `native=True` takes the runs from the
native host ops instead (`enhanced_unet_tpu_torch.native`, which raises if
it cannot be built).  Both give the same counts.
"""

from __future__ import annotations

from typing import Dict, List, Union

import numpy as np


def _mask_to_counts(mask: np.ndarray, native: bool = False) -> np.ndarray:
    """Column-major run lengths; the first run counts zeros (possibly 0)."""
    if native:
        from enhanced_unet_tpu_torch import native as hostops

        return hostops.rle_counts(np.asarray(mask))
    flat = np.asarray(mask, dtype=np.uint8).flatten(order="F")
    flat = (flat > 0).astype(np.uint8)
    n = flat.size
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    boundaries = np.concatenate(([0], change, [n]))
    counts = np.diff(boundaries).astype(np.int64)
    if flat[0] == 1:  # RLE must start with a zero-run
        counts = np.concatenate(([0], counts))
    return counts


def _counts_to_mask(counts: np.ndarray, h: int, w: int) -> np.ndarray:
    vals = np.zeros(len(counts), dtype=np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, counts)
    total = h * w
    if flat.size < total:
        flat = np.concatenate([flat, np.zeros(total - flat.size, dtype=np.uint8)])
    return flat[:total].reshape((h, w), order="F")


def rle_to_string(counts: np.ndarray) -> str:
    """pycocotools rleToString: delta-coded signed base-32 varints offset
    into printable ASCII (chr(c+48))."""
    out: List[str] = []
    cnts = [int(c) for c in counts]
    for i, x in enumerate(cnts):
        if i > 2:
            x -= cnts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5  # python's >> is arithmetic for negative ints, as in C
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def rle_from_string(s: Union[str, bytes]) -> np.ndarray:
    """Inverse of rle_to_string (pycocotools rleFrString)."""
    if isinstance(s, bytes):
        s = s.decode("utf-8")
    cnts: List[int] = []
    p = 0
    while p < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[p]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)  # sign-extend
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    return np.asarray(cnts, dtype=np.int64)


def encode_rle(mask: np.ndarray, native: bool = False) -> Dict:
    """COCO RLE dict {'size': [h, w], 'counts': str} for a binary HxW mask.

    Drop-in for `pycocotools.mask.encode(np.asfortranarray(mask))` with the
    counts already utf-8 decoded (the reference decodes immediately,
    train_eval.py:957-958).
    """
    h, w = mask.shape
    return {"size": [int(h), int(w)],
            "counts": rle_to_string(_mask_to_counts(mask, native))}


def decode_rle(rle: Dict) -> np.ndarray:
    """Binary HxW uint8 mask from a COCO RLE dict (string or raw counts)."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = rle_from_string(counts)
    return _counts_to_mask(np.asarray(counts, dtype=np.int64), h, w)


def rle_area(rle: Dict) -> int:
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = rle_from_string(counts)
    return int(np.asarray(counts[1::2], dtype=np.int64).sum())


def mask_to_bbox(mask: np.ndarray) -> List[float]:
    """[x, y, w, h] bounding box of nonzero pixels (cv2.boundingRect
    semantics: width/height include the last pixel)."""
    ys, xs = np.nonzero(np.asarray(mask))
    if len(xs) == 0:
        return [0.0, 0.0, 0.0, 0.0]
    x0, x1 = int(xs.min()), int(xs.max())
    y0, y1 = int(ys.min()), int(ys.max())
    return [float(x0), float(y0), float(x1 - x0 + 1), float(y1 - y0 + 1)]


def rle_to_bbox(rle: Dict) -> List[float]:
    return mask_to_bbox(decode_rle(rle))


def rle_iou(rle_a: Dict, rle_b: Dict) -> float:
    """Mask IoU between two RLEs (decode + logical ops; instance masks here
    are small so this is not a hot path)."""
    a = decode_rle(rle_a).astype(bool)
    b = decode_rle(rle_b).astype(bool)
    union = np.logical_or(a, b).sum()
    if union == 0:
        return 0.0
    return float(np.logical_and(a, b).sum() / union)
