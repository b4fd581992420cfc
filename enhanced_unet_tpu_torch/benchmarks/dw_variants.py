"""The depthwise 3x3 + bias + SiLU kernel on the card, against cuDNN: the
port of `benchmarks/pallas_dw_variants.py`.

    python -m enhanced_unet_tpu_torch.benchmarks.dw_variants

The TPU script times four tap strategies of one function (v1 and v2 are one
program; v3 stores the lane shifts first; v4 takes the column taps as a
banded 0/1 product, which is exact).  The port has one kernel for it,
`dw3x3_bias_silu` (`ops/kernels/depthwise.py`).  At [16,24,256,256] bf16 it
prints the device row, then the kernel's row (`microtime.kernel_row`):
checked against its plain version (raises above `PLAIN_TOL`) and against
`dw_library` (raises above `CHECK_TOL`), and timed beside both.
"""

from __future__ import annotations

import json
from typing import List, Optional, Union

import torch
import torch.nn.functional as F

from enhanced_unet_tpu_torch.benchmarks.microtime import device_row, kernel_row
from enhanced_unet_tpu_torch.device import resolve_device
from enhanced_unet_tpu_torch.ops.kernels.depthwise import (
    dw3x3_bias_silu,
    dw3x3_bias_silu_plain,
)

N, C, H, W = 16, 24, 256, 256
# The plain version has the kernel's rounding points; what remains is a bf16
# rounding that a different fp32 summation order can flip.
PLAIN_TOL = 2e-2
# The library rounds the convolution and the bias add to bf16 before the
# SiLU; the kernel sums in fp32 and rounds once.
CHECK_TOL = 2e-2


def dw_library(x: torch.Tensor, wdw: torch.Tensor, bdw: torch.Tensor) -> torch.Tensor:
    """cuDNN's depthwise convolution with bias, then SiLU, in x's dtype (the
    TPU script's `ref`).  A yardstick only; nothing of the port calls it."""
    return F.silu(F.conv2d(x, wdw.to(x.dtype)[:, None], bdw.to(x.dtype),
                           padding=1, groups=x.shape[1]))


def main(device: Optional[Union[str, torch.device]] = None) -> List[dict]:
    """The kernel on the card (`device=None`), or raise without one."""
    device = resolve_device(device)
    rows = [device_row(device)]
    print(json.dumps(rows[0]), flush=True)
    g = torch.Generator(device=device).manual_seed(0)
    x = (torch.randn(N, C, H, W, generator=g, device=device) * 0.5).to(torch.bfloat16)
    wdw = torch.randn(C, 3, 3, generator=g, device=device) * 0.1
    bdw = torch.randn(C, generator=g, device=device) * 0.1
    rows.append(kernel_row(
        "dw3x3_bias_silu", lambda: dw3x3_bias_silu(x, wdw, bdw),
        lambda: dw3x3_bias_silu_plain(x, wdw, bdw), PLAIN_TOL,
        library=lambda: dw_library(x, wdw, bdw), library_tol=CHECK_TOL))
    print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
