"""The fused MBConv inference block on the card, against the library's
channels_last ops: the port of `benchmarks/pallas_mbconv_proto.py`.

    python -m enhanced_unet_tpu_torch.benchmarks.mbconv_proto

The prototype's Pallas kernels (`mbconv_pallas`: `_pass1_kernel`,
`_pass2_kernel`) compute the function of the package's fused MBConv
(`enhanced_unet_tpu/ops/pallas/mbconv.py`) step for step, with the same
rounding points: the expand output cast to bf16, bf16 taps, an fp32
depthwise epilogue, a cast before the projection, bf16 gated weights.  They
differ from it only in TPU layout (a W+2 padded slab, `wdw` replicated
along the lanes, row slabs of 32).  So the port runs them as the port's
MBConv kernels (`ops/kernels/mbconv.py`: stage 0 on `csrc/mbconv_nhwc.cu`,
stage 1, an expand block, on `csrc/mbconv_nhwc_expand.cu`): `mbconv_proto`
only changes the parameter dict into `MBConvWeights`.

The parameter dict in the port's layout: `wexp` [mid,cin] bf16, `bexp` [mid],
`wdw` [mid,3,3] bf16, `bdw` [mid], `se_w1` [mid,se_c], `se_b1` [se_c],
`se_w2` [se_c,mid], `se_b2` [mid], `wproj` [mid,cout], `bproj` [cout]
(fp32 unless stated).

Rows printed (one JSON object each): the device, then one row per case
(`run_case`): the kernels' errors against the plain K1 path and against
`mbconv_nhwc_library`, and the times of the kernels, the plain path and
the library.  An error above its tolerance raises.
"""

from __future__ import annotations

import json
from typing import Dict, List, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from enhanced_unet_tpu_torch.benchmarks.microtime import device_row, kernel_row
from enhanced_unet_tpu_torch.device import resolve_device
from enhanced_unet_tpu_torch.ops.kernels.mbconv import (
    MBConvWeights,
    mbconv_infer_nchw,
    mbconv_infer_nchw_plain,
    variant_for,
)

DT = torch.bfloat16
# (name, n, cin, mid, cout, h, w, expand): the prototype's two cases
CASES = (
    ("stage0 24ch r1 @256^2", 16, 24, 24, 24, 256, 256, False),   # B5 stage 0
    ("stage1 40ch r6 @128^2", 16, 40, 240, 40, 128, 128, True),   # B5 stage 1
)
# The plain K1 path has the kernels' rounding points; what remains is a
# bf16 rounding that a different fp32 summation order can flip.
PLAIN_TOL = 2e-2
# The library path rounds every intermediate to bf16 (conv outputs, bias
# adds, SiLU, the gated activations), the kernels only where the TPU kernels
# do; 3e-2 of max |value| allows that, as tests/test_pallas_mbconv.py does.
CHECK_TOL = 3e-2

Params = Dict[str, torch.Tensor]


def make_params(generator: torch.Generator, cin: int, mid: int, cout: int,
                se_c: int) -> Params:
    """Seeded random parameters in the port's layout, at the prototype's
    scales, on the generator's device."""
    def r(shape, scale):
        return torch.randn(shape, generator=generator,
                           device=generator.device) * scale

    return {"wexp": r((mid, cin), 0.2).to(DT), "bexp": r((mid,), 0.1),
            "wdw": r((mid, 3, 3), 0.2).to(DT), "bdw": r((mid,), 0.1),
            "se_w1": r((mid, se_c), 0.2), "se_b1": r((se_c,), 0.1),
            "se_w2": r((se_c, mid), 0.2), "se_b2": r((mid,), 0.1),
            "wproj": r((mid, cout), 0.2), "bproj": r((cout,), 0.1)}


def params_from_jax(p: Mapping[str, np.ndarray]) -> Params:
    """The prototype's JAX parameters (numpy arrays, TPU layout: `wdw`
    [3,3,mid,1,W] and `bdw` [mid,1,W] replicated along the lanes, `bexp`
    [mid,1], `bproj` [cout,1]) in the port's layout."""
    def t(name):
        return torch.from_numpy(np.asarray(p[name], np.float32).copy())

    return {"wexp": t("wexp").to(DT), "bexp": t("bexp")[:, 0],
            "wdw": t("wdw")[:, :, :, 0, 0].permute(2, 0, 1).contiguous().to(DT),
            "bdw": t("bdw")[:, 0, 0].contiguous(),
            "se_w1": t("se_w1"), "se_b1": t("se_b1"), "se_w2": t("se_w2"),
            "se_b2": t("se_b2"), "wproj": t("wproj"), "bproj": t("bproj")[:, 0]}


def proto_weights(p: Params, expand: bool) -> MBConvWeights:
    """The parameter dict as the MBConv kernels' folded weights."""
    return MBConvWeights(
        wexp=p["wexp"] if expand else None, bexp=p["bexp"] if expand else None,
        wdw=p["wdw"], bdw=p["bdw"], se_w1=p["se_w1"], se_b1=p["se_b1"],
        se_w2=p["se_w2"], se_b2=p["se_b2"], wproj=p["wproj"], bproj=p["bproj"])


def mbconv_proto(x: torch.Tensor, p: Params, *, expand: bool,
                 residual: bool) -> torch.Tensor:
    """The prototype's block on NCHW x [N,Cin,H,W] bf16: pass 1, the SE gate
    folded into per-image projection weights, pass 2.  CPU tensor: the
    plain version.  CUDA tensor: the MBConv kernels."""
    return mbconv_infer_nchw(x, proto_weights(p, expand), residual=residual)


def mbconv_nhwc_library(xh: torch.Tensor, p: Params, *, expand: bool,
                        residual: bool) -> torch.Tensor:
    """The same block in the library's channels_last ops, every step in
    xh's dtype (as the prototype's `mbconv_xla_nhwc`): xh [N,H,W,Cin] ->
    [N,H,W,Cout].  A yardstick of speed and a check only; nothing of the
    port calls it."""
    dt = xh.dtype
    x = xh.permute(0, 3, 1, 2)            # NCHW view of channels_last memory
    y = x
    if expand:
        y = F.silu(F.conv2d(y, p["wexp"].to(dt)[:, :, None, None]) +
                   p["bexp"].to(dt)[None, :, None, None])
    mid = y.shape[1]
    y = F.conv2d(y, p["wdw"].to(dt)[:, None], padding=1, groups=mid)
    y = F.silu(y + p["bdw"].to(dt)[None, :, None, None])
    s = y.float().mean(dim=(2, 3))
    s = F.silu(s @ p["se_w1"] + p["se_b1"])
    g = torch.sigmoid(s @ p["se_w2"] + p["se_b2"])
    y = y * g.to(dt)[:, :, None, None]
    y = F.conv2d(y, p["wproj"].t().to(dt)[:, :, None, None])
    y = y + p["bproj"].to(dt)[None, :, None, None]
    if residual:
        y = y + x
    return y.permute(0, 2, 3, 1)


def run_case(name: str, n: int, cin: int, mid: int, cout: int, h: int, w: int,
             expand: bool, device: torch.device) -> dict:
    """One case's row (`microtime.kernel_row`), printed: the kernels on NCHW
    against the plain K1 path (raises above `PLAIN_TOL`) and against the
    library's channels_last block (raises above `CHECK_TOL`), then their
    times and the library's `speedup` over the kernels.  The kernels get the
    memory format their variant reads: channels_last for `nhwc` (stage 0)
    and `nhwc_expand` (stage 1), contiguous NCHW for `nchw`."""
    g = torch.Generator(device=device).manual_seed(0)
    p = make_params(g, cin, mid, cout, max(1, cin // 4))
    xh = (torch.randn(n, h, w, cin, generator=g, device=device) * 0.5).to(DT)
    xc = xh.permute(0, 3, 1, 2)                      # channels_last NCHW view
    if variant_for(xc, proto_weights(p, expand)) == "nchw":
        xc = xc.contiguous()
    row = kernel_row(
        name, lambda: mbconv_proto(xc, p, expand=expand, residual=True),
        lambda: mbconv_infer_nchw_plain(xc, proto_weights(p, expand), residual=True),
        PLAIN_TOL, library=lambda: mbconv_nhwc_library(
            xh, p, expand=expand, residual=True).permute(0, 3, 1, 2),
        library_tol=CHECK_TOL)
    row["speedup"] = row["library_ms"] / row["ms"]
    print(json.dumps(row), flush=True)
    return row


def main(device: Optional[Union[str, torch.device]] = None) -> List[dict]:
    """Both cases on the card (`device=None`), or raise without one."""
    device = resolve_device(device)
    rows = [device_row(device)]
    print(json.dumps(rows[0]), flush=True)
    for case in CASES:
        rows.append(run_case(*case, device=device))
    return rows


if __name__ == "__main__":
    main()
