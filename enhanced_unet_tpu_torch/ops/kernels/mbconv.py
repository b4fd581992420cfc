"""Fused MBConv inference block (NCHW): CUDA kernels and their plain
PyTorch version.

Replaces `enhanced_unet_tpu/ops/pallas/mbconv.py::mbconv_infer_nchw` (the
Pallas `_pass1_kernel` and `_pass2_kernel`, with `_fill_slab`,
`_expand_rows` and `_dw_silu`).  Two passes with the SE gate between them:

  pass 1: [1x1 expand (BN0 folded) + SiLU, cast ->] 3x3 stride-1 depthwise
          (BN1 folded, fp32 epilogue) + SiLU -> per-image channel sums
  SE:     pool -> 1x1 -> SiLU -> 1x1 -> sigmoid, folded into per-image
          projection weights [N, mid, Cout] (plain tensor code)
  pass 2: recompute expand/depthwise/SiLU, cast -> 1x1 projection with the
          gated weights (fp32 sums) + BN2-folded bias [+ residual]

The rounding points are the JAX kernel's: the expand output is cast to the
compute dtype, pass-1 sums come from the fp32 SiLU output, pass 2 casts the
SiLU output before the projection, and the gated projection weights are in
the compute dtype.  The kernels take bf16 (the serving dtype) and fp32.

What bounds it on the H100: bytes.  At the stage-0 shapes (48->24 and 24->24
channels at half the image resolution, no expand) the block does about 20
FLOPs per byte it must move in bf16, far below the card's bf16 ridge of about
295, and pass 2 reads its input a second time.  The design keeps the
mid-channel tensor out of device memory: each block stages one haloed input
tile in shared memory, expands and runs the depthwise there and, in pass 2,
projects from shared memory, so device memory sees the input twice and the
output once.  Pass 1 writes one partial sum per (image, tile, channel),
reduced inside the block in a fixed order; the wrapper sums the tiles, so
results do not depend on the order blocks run in (no atomics).  The inner
products run on CUDA cores in fp32; the TPU kernel's H % 8 and W % 128 limits
and its row-slab choice do not apply.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from enhanced_unet_tpu_torch.ops.kernels import build

LAUNCHES = {"mbconv_pass1": 0, "mbconv_pass2": 0}
_SOURCE = "mbconv"
_TILE_W = 32                       # csrc/mbconv.cu TW
_SMEM_LIMIT = 227 * 1024           # dynamic shared memory a block may use


class MBConvWeights(NamedTuple):
    """Folded weights (see `fold_mbconv_weights`)."""
    wexp: Optional[torch.Tensor]   # [mid, cin] compute dtype (BN0 folded) or None
    bexp: Optional[torch.Tensor]   # [mid] f32
    wdw: torch.Tensor              # [mid, 3, 3] compute dtype (BN1 folded)
    bdw: torch.Tensor              # [mid] f32
    se_w1: torch.Tensor            # [mid, se_c] f32
    se_b1: torch.Tensor            # [se_c] f32
    se_w2: torch.Tensor            # [se_c, mid] f32
    se_b2: torch.Tensor            # [mid] f32
    wproj: torch.Tensor            # [mid, cout] f32 (BN2 folded)
    bproj: torch.Tensor            # [cout] f32


def _fold_bn(bn: Sequence[torch.Tensor], eps: float):
    gamma, beta, mean, var = bn
    s = gamma * torch.rsqrt(var + eps)
    return s, beta - mean * s


def fold_mbconv_weights(expand: Optional[torch.Tensor], bn0, dw: torch.Tensor,
                        bn1, se_reduce, se_expand, project: torch.Tensor, bn2,
                        eps: float = 1e-3,
                        dtype: torch.dtype = torch.bfloat16) -> MBConvWeights:
    """Fold the BNs into the convs.  Torch layouts: expand [mid,cin,1,1] or
    None, dw [mid,1,3,3], se_reduce/se_expand (weight [out,in,1,1], bias),
    project [cout,mid,1,1]; bn* = (gamma, beta, running_mean, running_var)."""
    wexp = bexp = None
    if expand is not None:
        s0, b0 = _fold_bn(bn0, eps)
        wexp = (expand[:, :, 0, 0] * s0[:, None]).to(dtype)
        bexp = b0.float()
    s1, b1 = _fold_bn(bn1, eps)
    wdw = (dw[:, 0] * s1[:, None, None]).to(dtype)
    s2, b2 = _fold_bn(bn2, eps)
    wproj = project[:, :, 0, 0].t() * s2[None, :]
    return MBConvWeights(
        wexp=wexp, bexp=bexp, wdw=wdw, bdw=b1.float(),
        se_w1=se_reduce[0][:, :, 0, 0].t().float(), se_b1=se_reduce[1].float(),
        se_w2=se_expand[0][:, :, 0, 0].t().float(), se_b2=se_expand[1].float(),
        wproj=wproj.float(), bproj=b2.float())


def se_gated_projection(sums: torch.Tensor, p: MBConvWeights, hw: int,
                        dtype: torch.dtype) -> torch.Tensor:
    """Per-image channel sums [N, mid] -> SE-gated projection weights
    [N, mid, cout] in `dtype`."""
    pool = sums / hw
    s = F.silu(pool @ p.se_w1 + p.se_b1)
    g = torch.sigmoid(s @ p.se_w2 + p.se_b2)
    return (g[:, :, None] * p.wproj[None]).to(dtype)


def _dw_silu_plain(x: torch.Tensor, p: MBConvWeights) -> torch.Tensor:
    """fp32 SiLU(depthwise(expand(x))) with the kernel's rounding points."""
    y = x.float()
    if p.wexp is not None:
        y = torch.einsum("mc,nchw->nmhw", p.wexp.float(), y)
        y = y + p.bexp[None, :, None, None]
        y = (y * torch.sigmoid(y)).to(x.dtype).float()
    mid = p.wdw.shape[0]
    y = F.conv2d(y, p.wdw.float()[:, None], padding=1, groups=mid)
    y = y + p.bdw[None, :, None, None]
    return y * torch.sigmoid(y)


def mbconv_pass1_plain(x: torch.Tensor, p: MBConvWeights) -> torch.Tensor:
    """Plain pass 1: per-image channel sums [N, mid] (fp32)."""
    return _dw_silu_plain(x, p).sum(dim=(2, 3))


def mbconv_pass2_plain(x: torch.Tensor, p: MBConvWeights, wpp: torch.Tensor,
                       residual: bool) -> torch.Tensor:
    """Plain pass 2: project with the gated weights wpp [N, mid, cout]."""
    y = _dw_silu_plain(x, p).to(x.dtype).float()
    o = torch.einsum("nmhw,nmc->nchw", y, wpp.float())
    o = o + p.bproj[None, :, None, None]
    if residual:
        o = o + x.float()
    return o.to(x.dtype)


def mbconv_infer_nchw_plain(x: torch.Tensor, p: MBConvWeights, *,
                            residual: bool) -> torch.Tensor:
    """Plain version of the two-pass block: x [N,Cin,H,W] -> [N,Cout,H,W]."""
    wpp = se_gated_projection(mbconv_pass1_plain(x, p), p,
                              x.shape[2] * x.shape[3], x.dtype)
    return mbconv_pass2_plain(x, p, wpp, residual)


def _lib() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    if lib.mbconv_pass1.restype is not ctypes.c_int:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.mbconv_pass1.argtypes = [vp] * 6 + [i] * 7 + [vp]
        lib.mbconv_pass1.restype = i
        lib.mbconv_pass2.argtypes = [vp] * 8 + [i] * 9 + [vp]
        lib.mbconv_pass2.restype = i
        lib.mbconv_smem_bytes.argtypes = [i] * 6
        lib.mbconv_smem_bytes.restype = ctypes.c_longlong
    return lib


def _pick_tile_h(lib, cin, mid, cout, expand, bf16) -> int:
    for th in (8, 4, 2, 1):
        if lib.mbconv_smem_bytes(cin, mid, cout, th, int(expand),
                                 int(bf16)) <= _SMEM_LIMIT:
            return th
    raise ValueError(f"MBConv block cin={cin} mid={mid} cout={cout} does not "
                     "fit in shared memory")


class _Launch(NamedTuple):
    """Checked device operands shared by the two passes."""
    lib: ctypes.CDLL
    x: torch.Tensor
    wexp: Optional[torch.Tensor]
    bexp: Optional[torch.Tensor]
    wdw: torch.Tensor
    bdw: torch.Tensor
    th: int
    bf16: bool


def _prepare(x: torch.Tensor, p: MBConvWeights) -> _Launch:
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"mbconv takes bf16 or fp32, got {x.dtype}")
    if x.ndim != 4:
        raise ValueError(f"expected NCHW input, got shape {tuple(x.shape)}")
    cin = x.shape[1]
    mid = p.wdw.shape[0]
    expand = p.wexp is not None
    if p.wdw.shape != (mid, 3, 3) or (expand and p.wexp.shape != (mid, cin)) \
            or (not expand and mid != cin):
        raise ValueError("MBConv weights do not match the input channels")
    lib = _lib()
    bf16 = x.dtype == torch.bfloat16
    dev = x.device
    return _Launch(
        lib=lib, x=x.contiguous(),
        wexp=p.wexp.to(dev, x.dtype).contiguous() if expand else None,
        bexp=p.bexp.to(dev, torch.float32).contiguous() if expand else None,
        wdw=p.wdw.to(dev, x.dtype).contiguous(),
        bdw=p.bdw.to(dev, torch.float32).contiguous(),
        th=_pick_tile_h(lib, cin, mid, p.wproj.shape[1], expand, bf16),
        bf16=bf16)


def mbconv_pass1(x: torch.Tensor, p: MBConvWeights) -> torch.Tensor:
    """Pass 1 on the card: per-image channel sums [N, mid] (fp32).  The
    kernel writes one partial sum per (image, tile, channel); the tiles are
    summed here in a fixed order."""
    a = _prepare(x, p)
    n, cin, h, w = a.x.shape
    mid = p.wdw.shape[0]
    tiles = -(-h // a.th) * -(-w // _TILE_W)
    partial = torch.empty((n, tiles, mid), dtype=torch.float32, device=x.device)
    rc = a.lib.mbconv_pass1(build.ptr(a.x), build.ptr(a.wexp), build.ptr(a.bexp),
                            build.ptr(a.wdw), build.ptr(a.bdw), build.ptr(partial),
                            n, cin, mid, h, w, a.th, int(a.bf16),
                            build.stream_ptr(x.device))
    build.check(rc, "mbconv pass 1 launch")
    LAUNCHES["mbconv_pass1"] += 1
    return partial.sum(dim=1)


def mbconv_pass2(x: torch.Tensor, p: MBConvWeights, wpp: torch.Tensor,
                 residual: bool) -> torch.Tensor:
    """Pass 2 on the card: [N, Cout, H, W] in x's dtype."""
    a = _prepare(x, p)
    n, cin, h, w = a.x.shape
    mid = p.wdw.shape[0]
    cout = p.wproj.shape[1]
    if residual and cin != cout:
        raise ValueError("residual needs Cin == Cout")
    if wpp.shape != (n, mid, cout):
        raise ValueError(f"gated weights must be [N, mid, Cout], got {tuple(wpp.shape)}")
    wpp = wpp.to(x.device, x.dtype).contiguous()
    bproj = p.bproj.to(x.device, torch.float32).contiguous()
    out = torch.empty((n, cout, h, w), dtype=x.dtype, device=x.device)
    rc = a.lib.mbconv_pass2(build.ptr(a.x), build.ptr(a.wexp), build.ptr(a.bexp),
                            build.ptr(a.wdw), build.ptr(a.bdw), build.ptr(wpp),
                            build.ptr(bproj), build.ptr(out), n, cin, mid, cout,
                            h, w, a.th, int(residual), int(a.bf16),
                            build.stream_ptr(x.device))
    build.check(rc, "mbconv pass 2 launch")
    LAUNCHES["mbconv_pass2"] += 1
    return out


def mbconv_infer_nchw(x: torch.Tensor, p: MBConvWeights, *,
                      residual: bool) -> torch.Tensor:
    """Fused MBConv inference on NCHW input [N, Cin, H, W] (bf16 or fp32).
    CPU tensor: the plain version.  CUDA tensor: the two kernels with the SE
    gate between them, or an error for what they do not take."""
    if x.device.type == "cpu":
        return mbconv_infer_nchw_plain(x, p, residual=residual)
    wpp = se_gated_projection(mbconv_pass1(x, p), p, x.shape[2] * x.shape[3],
                              x.dtype)
    return mbconv_pass2(x, p, wpp, residual)
