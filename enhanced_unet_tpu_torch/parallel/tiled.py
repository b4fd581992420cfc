"""Tiled inference with the tiles split over the data axis, ported from
`enhanced_unet_tpu/parallel/tiled.py`.

A full-resolution micrograph gives dozens of tiles (`ops/tiling.py`), each
independent of the others: every rank forwards a contiguous share of the
grid, the probabilities are gathered on every rank, and the Hann-weighted
blend runs on the host, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from enhanced_unet_tpu_torch.ops.tiling import (
    cut_tiles,
    hann_window_2d,
    reflect_pad,
    stitch,
    tile_grid,
)
from enhanced_unet_tpu_torch.parallel.mesh import Mesh


def tiled_inference_sharded(apply_fn: Callable[[torch.Tensor], torch.Tensor],
                            image: torch.Tensor, mesh: Mesh, tile: int = 512,
                            overlap: int = 64, num_classes: int = 3) -> torch.Tensor:
    """Full-resolution probabilities [H, W, C] (fp32, on the CPU) of an
    [H, W, 3] image: the grid's tiles, padded with zero tiles to a multiple
    of the ranks, split into contiguous chunks; this rank's chunk goes
    through `apply_fn` ([n, tile, tile, 3] -> logits) on its device and a
    softmax in fp32; the chunks are all-gathered and blended.  Every rank
    calls it with the same image and gets the same result."""
    h, w = int(image.shape[0]), int(image.shape[1])
    ph, pw, positions = tile_grid(h, w, tile, overlap)
    tiles = cut_tiles(reflect_pad(image.to(mesh.device), ph, pw)[None], positions, tile)
    n = len(positions)
    per = -(-n // mesh.size)
    if per * mesh.size > n:
        tiles = torch.cat([tiles, tiles.new_zeros((per * mesh.size - n, *tiles.shape[1:]))])
    with torch.no_grad():
        probs = torch.softmax(apply_fn(tiles[mesh.rank * per:(mesh.rank + 1) * per]).float(),
                              dim=-1).contiguous()
    if probs.shape[-1] != num_classes:
        raise ValueError(f"apply_fn gave {probs.shape[-1]} classes, expected {num_classes}")
    chunks = [torch.empty_like(probs) for _ in range(mesh.size)]
    dist.all_gather(chunks, probs, group=mesh.group)
    probs = torch.cat(chunks)[:n].cpu()
    window = torch.from_numpy(hann_window_2d(tile))[..., None]
    return stitch(probs[None], positions, ph, pw, window)[0, :h, :w]
