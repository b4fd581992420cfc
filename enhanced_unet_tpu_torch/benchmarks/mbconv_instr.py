"""Where the MBConv block's time goes, piece by piece, on the card: the
port of `benchmarks/pallas_mbconv_instr.py`.

    python -m enhanced_unet_tpu_torch.benchmarks.mbconv_instr

At the stage-0 case ([16,24,256,256] bf16, no expand, row slabs of 32) it
prints one JSON row each:

  ident, elementwise : plain torch (nothing; one elementwise kernel): the
                       launch floor, `ms` only
  copy               : the copy kernel (`ops/kernels/copy.py`), the memory
                       floor, with `Tensor.copy_` (a device-to-device
                       memcpy) as its library call and the achieved GB/s
                       (bytes read + written) of both
  dw_only            : the row-only depthwise probe (`dw_rows_silu`), with
                       `yardstick_ms`: cuDNN's grouped 3x1 conv (the probe's
                       three row taps) + bias + SiLU on the same input, the
                       same work but not the same function (the probe's
                       slab edges read other rows), so not checked
  pass1, pass2, full : the MBConv kernels on `mbconv_proto`'s weights;
                       pass 2 projects with the ungated weights, as the
                       TPU bench does; full is `mbconv_proto`

Every kernel row is a `microtime.kernel_row`: checked against the kernel's
plain version (raises above its tolerance) and timed beside it.
"""

from __future__ import annotations

import json
from typing import List, Optional, Union

import torch
import torch.nn.functional as F

from enhanced_unet_tpu_torch.benchmarks.mbconv_proto import (
    DT,
    make_params,
    mbconv_proto,
    proto_weights,
)
from enhanced_unet_tpu_torch.benchmarks.microtime import (
    device_ms,
    device_row,
    kernel_row,
    time_op,
)
from enhanced_unet_tpu_torch.device import resolve_device
from enhanced_unet_tpu_torch.ops.kernels import copy, depthwise, mbconv

N, C, H, W = 16, 24, 256, 256
BH = 32
# bf16 outputs: a bf16 rounding that the fp32 summation order can flip;
# pass 1's fp32 channel sums: the summation order alone
BF16_TOL, SUMS_TOL = 2e-2, 1e-3


def main(device: Optional[Union[str, torch.device]] = None) -> List[dict]:
    """Every row on the card (`device=None`), or raise without one."""
    device = resolve_device(device)
    rows = [device_row(device)]
    print(json.dumps(rows[0]), flush=True)
    g = torch.Generator(device=device).manual_seed(0)
    p = make_params(g, C, C, C, 6)
    x = (torch.randn(N, C, H, W, generator=g, device=device) * 0.5).to(DT)
    w = proto_weights(p, expand=False)
    wpp = p["wproj"].to(DT)[None].expand(N, C, C).contiguous()
    lib_out = torch.empty_like(x)
    moved = 2 * x.numel() * x.element_size()     # read once, written once

    for name, fn in [("ident", lambda x: x), ("elementwise", lambda x: x * 1.0001)]:
        rows.append({"bench": name, "ms": time_op(fn, x)})
        print(json.dumps(rows[-1]), flush=True)
    for name, kernel, plain, tol, library in [
            ("copy", lambda: copy.copy(x), lambda: copy.copy_plain(x), 0.0,
             lambda: lib_out.copy_(x)),
            ("dw_only", lambda: depthwise.dw_rows_silu(x, p["wdw"], p["bdw"], BH),
             lambda: depthwise.dw_rows_silu_plain(x, p["wdw"], p["bdw"], BH), BF16_TOL, None),
            ("pass1", lambda: mbconv.mbconv_pass1(x, w),
             lambda: mbconv.mbconv_pass1_plain(x, w), SUMS_TOL, None),
            ("pass2", lambda: mbconv.mbconv_pass2(x, w, wpp, True),
             lambda: mbconv.mbconv_pass2_plain(x, w, wpp, True), BF16_TOL, None),
            ("full", lambda: mbconv_proto(x, p, expand=False, residual=True),
             lambda: mbconv.mbconv_infer_nchw_plain(x, w, residual=True), BF16_TOL, None)]:
        row = kernel_row(name, kernel, plain, tol, library=library, library_tol=0.0)
        if name == "copy":
            row.update(gb_per_s=moved / row["ms"] / 1e6,
                       library_gb_per_s=moved / row["library_ms"] / 1e6)
        if name == "dw_only":
            w31 = p["wdw"].to(DT).sum(2)[:, None, :, None]        # [C, 1, 3, 1]
            row["yardstick_ms"] = device_ms(lambda: F.silu(F.conv2d(
                x, w31, p["bdw"].to(DT), padding=(1, 0), groups=C)), 30)
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
