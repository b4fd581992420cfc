"""Faults planted in the program's timed path, to show that the comparison
which decides `correct` catches them: the CPU tests drive them at small
sizes, `calibrate.py --faults` at a cell's own size on the card.

Each fault takes `patch(owner, name, value)`, which replaces an attribute
until the caller undoes it (pytest's `monkeypatch.setattr`, or `Patches`).
"""

from __future__ import annotations

import numpy as np
import torch


class Patches:
    """`patch(owner, name, value)` that remembers what it replaced; `undo`
    puts it back."""

    def __init__(self):
        self.saved = []

    def __call__(self, owner, name, value) -> None:
        self.saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def undo(self) -> None:
        for owner, name, value in reversed(self.saved):
            setattr(owner, name, value)
        self.saved.clear()


def altered_answer(patch) -> None:
    """The masks' classes moved on by one where the cascade makes them."""
    from enhanced_unet_tpu_torch.train import evaluator as ev

    cascade = ev.convert_probs_to_mask
    patch(ev, "convert_probs_to_mask", lambda p: (cascade(p) + 1) % 3)


def altered_probabilities(patch) -> None:
    """The classes' probabilities rolled where TTA produces them."""
    from enhanced_unet_tpu_torch.train import evaluator as ev

    tta = ev.tta_probs_batch
    patch(ev, "tta_probs_batch", lambda *a, **k: tta(*a, **k).roll(1, -1))


def stale_image(patch) -> None:
    """Each request answered from the images of the request before it."""
    from enhanced_unet_tpu_torch.train import evaluator as ev

    upload = ev.Evaluator._upload
    last = {}

    def stale(self, images01):
        before = last.get("images", images01)
        last["images"] = np.array(images01, copy=True)
        return upload(self, before)

    patch(ev.Evaluator, "_upload", stale)


def swapped_tiles(patch) -> None:
    """The first and the last tile of the grid exchanged where the tiles
    are cut, so each is stitched in the other's place."""
    from enhanced_unet_tpu_torch.train import evaluator as ev

    cut = ev.cut_tiles

    def swapped(images, positions, tile):
        tiles = cut(images, positions, tile)
        order = list(range(tiles.shape[0]))
        order[0], order[-1] = order[-1], order[0]
        return tiles[order]

    patch(ev, "cut_tiles", swapped)


def dropped_flip(patch) -> None:
    """TTA's horizontal flip left out: the mean of the other four views."""
    from enhanced_unet_tpu_torch.ops import tta
    from enhanced_unet_tpu_torch.train import evaluator as ev

    def without_hflip(apply_fn, images, enable_tta=True, scales=(0.75, 1.25)):
        b, h, w = images.shape[:3]
        if not enable_tta:
            return tta._probs(apply_fn, images, h, w)
        probs = tta._probs(apply_fn, torch.cat([images, images.flip(1)]), h, w)
        acc = [probs[:b], probs[b:].flip(1)]
        for s in scales:
            sh, sw = int(h * s), int(w * s)
            p = tta._probs(apply_fn, tta.resize_bilinear(images, (sh, sw)), sh, sw)
            acc.append(tta.resize_bilinear(p, (h, w)))
        return torch.stack(acc).mean(dim=0)

    patch(ev, "tta_probs_batch", without_hflip)


# the faults a tiled cell can have (a request of one frame)
TILED = ("altered_answer", "altered_probabilities", "stale_image", "dropped_flip",
         "swapped_tiles")
