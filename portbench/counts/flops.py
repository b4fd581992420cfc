"""Model FLOPs, counted on the benchmark's own reference on the meta
device by `torch.utils.flop_counter` (convolutions and matrix products,
2 per multiply-add; element-wise work is not counted)."""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode


def forward_flops(build: Callable[[], torch.nn.Module],
                  shapes: Iterable[Tuple[int, int, int]], backward: bool = False) -> int:
    """FLOPs of forwards on [n, 3, h, w] images for each (n, h, w) of
    `shapes` (with the backward of every output when `backward`), counted
    once per image size and scaled by n."""
    per_image: Dict[Tuple[int, int], int] = {}
    total = 0
    with torch.device("meta"):
        model = build()
    model.eval()
    for n, h, w in shapes:
        if (h, w) not in per_image:
            x = torch.zeros((1, 3, h, w), device="meta")
            with FlopCounterMode(display=False) as counter:
                if backward:
                    logits, aux = model(x)
                    out = logits.sum() + sum(t.sum() for t in aux.values())
                    out.backward()
                else:
                    with torch.no_grad():
                        model(x)
            per_image[(h, w)] = counter.get_total_flops()
        total += n * per_image[(h, w)]
    return total
