"""The band of rows a model computes on under spatial partitioning.

`parallel.spatial.SpatialMode` runs a model on this rank's band of rows of
a map split over ranks along H.  It sees every PyTorch call, but not the
fused kernels' `ctypes` launches (K2 and K1): so `models.blocks.conv_bn_act`
and `models.encoders.MBConvBlock` ask `active()` first.  With no spatial
run active it is None and they take their usual path unchanged; else they
hand their kernel call to `active().stencil(x, halo, fn)`, which runs `fn`
on the band haloed by `halo` rows (from the neighbours, zeros beyond the
image) and keeps this rank's rows of its result.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Tuple

import torch


class Own(NamedTuple):
    """What a stencil's `fn` is told about the haloed input it gets."""

    rows: Tuple[int, int]                  # the rows [lo, hi) this rank owns
    reduce: Callable[[torch.Tensor], None]  # sums a per-image partial over the ranks, in place
    hw: int                                # pixels of the whole map (H x W)


_ACTIVE: List[object] = []


def active():
    """The spatial run in progress (a `parallel.spatial.SpatialMode`), or
    None."""
    return _ACTIVE[-1] if _ACTIVE else None
