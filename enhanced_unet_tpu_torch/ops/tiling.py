"""Sliding-window tiled inference with Hann overlap-blend stitching, ported
from `enhanced_unet_tpu/ops/tiling.py`.

A large micrograph is segmented at full resolution: a static grid of
`tile`-sized windows, `overlap` pixels apart at their edges, the last one
snapped to the image edge; each window's probabilities weighted by a 2-D
Hann window and accumulated, then divided by the accumulated weight.
Images smaller than a tile are reflect-padded up to it.

Tensors are NHWC (or HWC) on the image's device; `apply_fn` maps
[B, tile, tile, 3] images to [B, tile, tile, C] logits.  The JAX version
fills its last batch with zero tiles for a fixed compiled shape; those
change no output, and the port runs the last batch short instead.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch

from enhanced_unet_tpu_torch.ops.thresholding import convert_probs_to_mask

ApplyFn = Callable[[torch.Tensor], torch.Tensor]


def _tile_positions(size: int, tile: int, stride: int) -> List[int]:
    """Start offsets covering [0, size) with the last tile snapped to the
    edge (so every pixel is covered exactly, no partial tiles)."""
    if size <= tile:
        return [0]
    pos = list(range(0, size - tile + 1, stride))
    if pos[-1] != size - tile:
        pos.append(size - tile)
    return pos


def hann_window_2d(tile: int, eps: float = 1e-3) -> np.ndarray:
    """Separable 2D Hann blending window, floored at eps so edge pixels of
    edge tiles still receive weight."""
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * (np.arange(tile) + 0.5) / tile)
    w2 = np.outer(w, w)
    return np.maximum(w2, eps).astype(np.float32)


def tile_grid(h: int, w: int, tile: int,
              overlap: int) -> Tuple[int, int, List[Tuple[int, int]]]:
    """(padded height, padded width, tile corners (y, x) in row-major
    order) of the grid over an [h, w] image."""
    stride = tile - overlap
    if stride <= 0:
        raise ValueError("overlap must be smaller than tile")
    ph, pw = max(h, tile), max(w, tile)
    return ph, pw, [(y, x) for y in _tile_positions(ph, tile, stride)
                    for x in _tile_positions(pw, tile, stride)]


def reflect_pad(images: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Bottom/right reflect padding of [..., H, W, C] up to [..., ph, pw,
    C], with numpy's `mode="reflect"` (any pad width, as `jnp.pad`)."""
    h, w = images.shape[-3], images.shape[-2]
    if (ph, pw) == (h, w):
        return images
    rows = torch.from_numpy(np.pad(np.arange(h), (0, ph - h), mode="reflect"))
    cols = torch.from_numpy(np.pad(np.arange(w), (0, pw - w), mode="reflect"))
    out = images.index_select(-3, rows.to(images.device))
    return out.index_select(-2, cols.to(images.device))


def cut_tiles(images: torch.Tensor, positions: List[Tuple[int, int]],
              tile: int) -> torch.Tensor:
    """[B, H, W, C] -> [B * n, tile, tile, C], image-major, each image's
    tiles in `positions` order."""
    tiles = torch.stack([images[:, y:y + tile, x:x + tile] for y, x in positions], 1)
    return tiles.reshape(-1, tile, tile, images.shape[-1])


def stitch(probs: torch.Tensor, positions: List[Tuple[int, int]], ph: int,
           pw: int, window: torch.Tensor) -> torch.Tensor:
    """[B, n, tile, tile, C] tile probabilities -> [B, ph, pw, C], each
    weighted by `window` [tile, tile, 1] and divided by the summed weight
    (fp32, accumulated in `positions` order)."""
    b, _, tile, _, c = probs.shape
    acc = torch.zeros((b, ph, pw, c), dtype=torch.float32, device=probs.device)
    wacc = torch.zeros((ph, pw, 1), dtype=torch.float32, device=probs.device)
    for i, (y, x) in enumerate(positions):
        acc[:, y:y + tile, x:x + tile] += probs[:, i] * window
        wacc[y:y + tile, x:x + tile] += window
    return acc / torch.clamp(wacc, min=1e-8)


def tiled_inference(apply_fn: ApplyFn, image: torch.Tensor, tile: int = 512,
                    overlap: int = 64, batch_size: int = 8, num_classes: int = 3,
                    use_window: bool = True) -> torch.Tensor:
    """Full-resolution probabilities [H, W, C] (fp32) of an [H, W, 3]
    image of any size: the tiles' logits in batches of `batch_size`,
    softmaxed, blended."""
    h, w = int(image.shape[0]), int(image.shape[1])
    ph, pw, positions = tile_grid(h, w, tile, overlap)
    tiles = cut_tiles(reflect_pad(image, ph, pw)[None], positions, tile)
    probs = torch.cat([torch.softmax(apply_fn(tiles[s:s + batch_size]).float(), dim=-1)
                       for s in range(0, tiles.shape[0], batch_size)])
    window = (torch.from_numpy(hann_window_2d(tile)) if use_window
              else torch.ones((tile, tile)))[..., None].to(image.device)
    full = stitch(probs[None], positions, ph, pw, window)[0]
    if full.shape[-1] != num_classes:
        raise ValueError(f"apply_fn gave {full.shape[-1]} classes, expected {num_classes}")
    return full[:h, :w]


def tiled_semantic_mask(apply_fn: ApplyFn, image: torch.Tensor, tile: int = 512,
                        overlap: int = 64, batch_size: int = 8) -> torch.Tensor:
    """Full-resolution semantic mask [H, W] (int32) via tiling and the
    reference threshold cascade."""
    probs = tiled_inference(apply_fn, image, tile=tile, overlap=overlap,
                            batch_size=batch_size)
    return convert_probs_to_mask(probs)
