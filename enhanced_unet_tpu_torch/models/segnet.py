"""SegNet, ported from `enhanced_unet_tpu/models/segnet.py`: four
encoder stages of two 3x3 ConvBNActs (`enc1`..`enc4`), each followed by a 2x2
max pool that keeps its window argmax; the decoder unpools at those indices
and narrows through ConvBNAct pairs (`dec4`..`dec2`, then `dec1`'s one);
a 1x1 head (`head`)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from enhanced_unet_tpu_torch.models.blocks import (
    ConvBNAct,
    NHWCModel,
    conv,
    max_pool_with_indices,
    max_unpool_2x2,
    row_split,
)


class SegNet(NHWCModel):
    def __init__(self, num_classes: int = 3, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        # the flax model's ConvBNActs are flat (`ConvBNAct_0` .. `_14`), so
        # only enc1's second conv sits where tensor parallelism row-splits
        for i, (cin, cout) in enumerate(((3, 64), (64, 128), (128, 256), (256, 512)), 1):
            setattr(self, f"enc{i}", nn.Sequential(ConvBNAct(cin, cout, dtype=dtype),
                                                   ConvBNAct(cout, cout, dtype=dtype)))
        row_split(self.enc1[1][0])
        for i, (c, cout) in zip((4, 3, 2), ((512, 256), (256, 128), (128, 64))):
            setattr(self, f"dec{i}", nn.Sequential(ConvBNAct(c, c, dtype=dtype),
                                                   ConvBNAct(c, cout, dtype=dtype)))
        self.dec1 = nn.Sequential(ConvBNAct(64, 64, dtype=dtype))
        self.head = nn.Conv2d(64, num_classes, 1)
        self.dtype = dtype

    def logits(self, x, generator: Optional[torch.Generator] = None):
        indices = []
        for i in range(1, 5):
            x, idx = max_pool_with_indices(getattr(self, f"enc{i}")(x))
            indices.append(idx)
        for i in range(4, 0, -1):
            x = getattr(self, f"dec{i}")(max_unpool_2x2(x, indices[i - 1]))
        return conv(x, self.head, self.dtype)
