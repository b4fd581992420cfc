"""Tiled inference with the tiles split over the data axis, ported from
`enhanced_unet_tpu/parallel/tiled.py`.

A full-resolution micrograph gives dozens of tiles (`ops/tiling.py`), each
independent of the others: every rank forwards a contiguous share of the
grid, the probabilities are gathered on every rank, and the Hann-weighted
blend runs on the host, as in the JAX package.  `map_tiles_sharded` is that
share-and-gather step alone; the Evaluator's tiled path with a mesh
(`train/evaluator.py`) runs its chunks through it too.
"""

from __future__ import annotations

from typing import Callable

import torch

from enhanced_unet_tpu_torch.ops.tiling import (
    cut_tiles,
    hann_window_2d,
    reflect_pad,
    stitch,
    tile_grid,
)
from enhanced_unet_tpu_torch.parallel.mesh import Mesh, gather


def map_tiles_sharded(fn: Callable[[torch.Tensor], torch.Tensor], tiles: torch.Tensor,
                      mesh: Mesh) -> torch.Tensor:
    """`fn` of every tile, each rank computing its contiguous share: `tiles`
    (a count that divides by the ranks) cut into `mesh.size` equal chunks,
    this rank's through `fn` on its device, the results all-gathered over
    the mesh in rank order (staged through host memory under gloo).  Every
    rank calls it with the same tiles and gets the same result."""
    if tiles.shape[0] % mesh.size:
        raise ValueError(f"{tiles.shape[0]} tiles do not split over {mesh.size} ranks")
    per = tiles.shape[0] // mesh.size
    with torch.no_grad():
        out = fn(tiles[mesh.rank * per:(mesh.rank + 1) * per]).contiguous()
    return gather(mesh, out, 0)


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

    def probs_of(share):
        probs = torch.softmax(apply_fn(share).float(), dim=-1)
        if probs.shape[-1] != num_classes:
            raise ValueError(f"apply_fn gave {probs.shape[-1]} classes, expected {num_classes}")
        return probs

    probs = map_tiles_sharded(probs_of, tiles, mesh)[:n].cpu()
    window = torch.from_numpy(hann_window_2d(tile))[..., None]
    return stitch(probs[None], positions, ph, pw, window)[0, :h, :w]
