"""Learning-rate table, ported from `enhanced_unet_tpu/train/schedule.py`:
linear warmup, then cosine annealing with warm restarts, stepped once per
epoch before the epoch's training, as the reference's loop steps torch's
`LinearLR` and `CosineAnnealingWarmRestarts` (only one of the two steps in
an epoch, so the cosine's T_cur starts moving at the first epoch after the
warmup).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np


def reference_lr_schedule(base_lr: float, total_epochs: int, warmup_epochs: int,
                          t0: int, t_mult: int = 2, eta_min: float = 1e-7,
                          start_factor: float = 0.001) -> np.ndarray:
    """The LR in effect during each epoch's training (float64)."""
    lrs = np.zeros(total_epochs, dtype=np.float64)
    t_i, t_cur = t0, 0
    for epoch in range(total_epochs):
        if epoch < warmup_epochs:
            # LinearLR's closed form after epoch + 1 steps
            factor = start_factor + (1.0 - start_factor) * min(
                epoch + 1, warmup_epochs) / warmup_epochs
            lrs[epoch] = base_lr * factor
        else:
            # CosineAnnealingWarmRestarts.step(): advance, roll over into the
            # next (t_mult times longer) cycle, then compute
            t_cur += 1
            if t_cur >= t_i:
                t_cur -= t_i
                t_i *= t_mult
            lrs[epoch] = eta_min + (base_lr - eta_min) * (
                1 + math.cos(math.pi * t_cur / t_i)) / 2
    return lrs


def make_lr_fn(lr_table: Sequence[float],
               steps_per_epoch: int) -> Callable[[int], float]:
    """Update count -> the LR of its epoch, rounded to float32 as the JAX
    package's table holds it.  The count is the number of updates made
    before this one; counts past the table keep its last LR."""
    table = np.asarray(lr_table, dtype=np.float32)

    def lr_fn(count: int) -> float:
        return float(table[min(max(count // steps_per_epoch, 0), len(table) - 1)])

    return lr_fn
