"""Native host ops of the evaluation path (`hostops.cpp`: column-major RLE
runs, packed-popcount mask IoU), bound with `ctypes`.

The library is built with `g++ -O3 -shared -fPIC` at first use into
`build/hostops/` at the repository root, its file name carrying a hash of
the source, and loaded once.  A missing `g++` or a failed build raises:
callers that ask for the native ops get them or an error, never the numpy
versions (`data/rle.py`, `metrics/instance.py` keep those, and the
Evaluator uses them on the CPU).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "hostops.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hostops"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libhostops-{digest}.so"


def _build(out: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native host ops cannot be built")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE.name} (rc {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises if it cannot be."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            i64, vp = ctypes.c_int64, ctypes.c_void_p
            lib.rle_encode.argtypes = [vp, i64, i64, vp, i64]
            lib.rle_encode.restype = i64
            lib.rle_decode.argtypes = [vp, i64, vp, i64, i64]
            lib.rle_decode.restype = None
            lib.pack_masks.argtypes = [vp, i64, i64, vp, i64]
            lib.pack_masks.restype = None
            lib.mask_iou_packed.argtypes = [vp, i64, vp, i64, i64, vp]
            lib.mask_iou_packed.restype = None
            _lib = lib
        return _lib


def rle_counts(mask: np.ndarray) -> np.ndarray:
    """Column-major run lengths of a binary [H, W] mask, the first run
    counting zeros (int64)."""
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    if mask.ndim != 2:
        raise ValueError(f"expected an [H, W] mask, got shape {mask.shape}")
    h, w = mask.shape
    buf = np.empty(h * w + 1, dtype=np.int64)
    n = load().rle_encode(mask.ctypes.data, h, w, buf.ctypes.data, buf.size)
    if n < 0:
        raise RuntimeError("rle_encode: run buffer too small")
    return buf[:n].copy()


def rle_decode(counts: np.ndarray, h: int, w: int) -> np.ndarray:
    """Binary [h, w] uint8 mask from column-major run lengths."""
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    out = np.empty((h, w), dtype=np.uint8)
    load().rle_decode(counts.ctypes.data, counts.size, out.ctypes.data, h, w)
    return out


def pairwise_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU matrix [n_a, n_b] (float64) over stacks of binary masks, by
    packed popcount; a pair of empty masks gets 0."""
    na, nb = a.shape[0], b.shape[0]
    px = int(np.prod(a.shape[1:]))
    if int(np.prod(b.shape[1:])) != px:
        raise ValueError(f"mask shapes differ: {a.shape[1:]} and {b.shape[1:]}")
    if na == 0 or nb == 0:
        return np.zeros((na, nb))
    lib = load()
    words = (px + 63) // 64
    a8 = np.ascontiguousarray(a.reshape(na, px), dtype=np.uint8)
    b8 = np.ascontiguousarray(b.reshape(nb, px), dtype=np.uint8)
    pa = np.empty(na * words, dtype=np.uint64)
    pb = np.empty(nb * words, dtype=np.uint64)
    lib.pack_masks(a8.ctypes.data, na, px, pa.ctypes.data, words)
    lib.pack_masks(b8.ctypes.data, nb, px, pb.ctypes.data, words)
    out = np.empty(na * nb, dtype=np.float64)
    lib.mask_iou_packed(pa.ctypes.data, na, pb.ctypes.data, nb, words, out.ctypes.data)
    return out.reshape(na, nb)
