"""The part of a model's maps and weights a rank computes on under a
partitioned run.

`parallel.spatial.SpatialMode` runs a model on this rank's band of rows of
a map split over ranks along H; `parallel.tensor_parallel.
TensorParallelMode` on the wide conv weights split over ranks along their
channels (each rank a slice, recorded on the parameter as a `Split`).
Each sees every PyTorch call of the forward, but not the fused kernels'
`ctypes` launches (K2 and K1): so `models.blocks.conv_bn_act` and
`models.encoders.MBConvBlock` ask `active()` first.  With no partitioned
run active it is None and they take their usual path unchanged; else they
hand their kernel call to it:

- `conv3x3(x, layer, bn, relu, dtype, run)`: K2 for `layer` + `bn` (+
  ReLU) on x, where `run(x, own=None, packed=None, relu=relu)` launches it
  on an NCHW input (`layer`'s own pack where `packed` is None);
- `mbconv(x, block, run)`: K1 for the `MBConvBlock` `block` on x, where
  `run(x, weights, own=None)` launches it with the folded `weights`.

`own`, where a mode passes one, is the `Own` of a band haloed by its
neighbours' rows (spatial partitioning).

Tensor parallelism also trains (spatial partitioning refuses train mode):
there `models.blocks.batch_norm`, `dropout` and `models.encoders.drop_path`
ask `active()` too, and hand it

- `batch_norm(x, bn)`: `bn`'s train-mode BatchNorm of x with the
  statistics of the whole batch (the batch split over ranks, x perhaps a
  channel slice);
- `uniform(x, generator, per_sample=False)`: fp32 uniforms for x (one a
  sample, `[N, 1, 1, 1]`, with `per_sample`): this rank's part of the
  draws over the whole batch.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import torch


class Own(NamedTuple):
    """What a stencil's `run` is told about the haloed input it gets."""

    rows: Tuple[int, int]                  # the rows [lo, hi) this rank owns
    reduce: Callable[[torch.Tensor], None]  # sums a per-image partial over the ranks, in place
    hw: int                                # pixels of the whole map (H x W)


# the attribute of a parameter (and of what a cast of it gives) that holds
# its `Split`
SPLIT = "_tp_split"


class Split(NamedTuple):
    """This rank's slice [lo, hi) of `full` channels of a weight, along its
    dim `dim`: output channels ("column": an `nn.Conv2d`'s dim 0, an
    `nn.ConvTranspose2d`'s dim 1) or input channels ("row": dim 1)."""

    kind: str
    dim: int
    lo: int
    hi: int
    full: int


def split_of(t: Optional[torch.Tensor]) -> Optional[Split]:
    """The `Split` of a sharded weight, or None for a whole one."""
    return getattr(t, SPLIT, None) if isinstance(t, torch.Tensor) else None


_ACTIVE: List[object] = []


def active():
    """The partitioned run in progress (a `SpatialMode` or a
    `TensorParallelMode`), or None."""
    return _ACTIVE[-1] if _ACTIVE else None
