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

Each kernel pair keeps the mid-channel tensor out of device memory: a block
stages a haloed input tile in shared memory, expands it and runs the
depthwise there and, in pass 2, projects from shared memory, so device
memory sees the input twice and the output once.  Pass 1 writes one partial
sum per (image, tile, channel), reduced inside the block in a fixed order;
the wrapper sums the tiles, so results do not depend on the order blocks run
in (no atomics).  The TPU kernel's H % 8 and W % 128 limits and its
row-slab choice do not apply.

Three pairs of kernels, chosen by shape and dtype alone (`variant_for`):

- `nhwc` (`csrc/mbconv_nhwc.cu`): the serving path's blocks, bf16 with no
  expand, mid = Cin and Cout multiples of 8 up to 64.  They read and write
  NHWC memory, so a channels_last input goes in with no copy and the result
  is channels_last; haloed tiles of 16 or 8 rows x 32 pixels (the rows by
  `nhwc_tile_rows`, from the grid and the blocks the card holds) filled by
  16-byte `cp.async` copies, a depthwise whose threads own 8 channels of
  one column, and the projection on `mma.sync` tensor cores.
- `nhwc_expand` (`csrc/mbconv_nhwc_expand.cu`): bf16 blocks with an
  expand, Cin and Cout multiples of 8 up to 64 and mid a multiple of 8
  (EfficientNet's stage-1 expand blocks: 40 -> 240 -> 40, 32 -> 192 -> 32).
  The same tiles and depthwise as `nhwc`, with the expand as a GEMM on
  `mma.sync` in front of it and mid taken in chunks of 64 channels (the
  last one what is left), so shared memory does not grow with mid; pass 2
  accumulates the projection over the chunks in registers.
  Channels_last in and out.
- `nchw` (`csrc/mbconv.cu`): every other block (fp32, wider or odd
  channel counts, any Cin, mid and Cout), NCHW in and out.  Tiles of 256
  pixels in whole row segments (bf16 64 x 4 on maps wider than 32, else
  32 x 8; fp32 32 x 8) copied 16 bytes at a time, mid in chunks of 32 and
  Cout in blocks of 32 or 64, an input wider than 64 channels streamed in
  chunks of 32; bf16 GEMMs on `mma.sync`, fp32 on register-tiled FMAs;
  pass 1 without an expand streams rows instead of tiles.  The library
  plans the tiles (`mbconv_nchw_tiles` gives the partial sums' tile
  count) and takes W not a multiple of 16 bytes or a misaligned start in
  an element-wise instantiation.

Spatial partitioning (`parallel/spatial.py`) hands a block a band of rows
haloed by one row on each side: pass 1 then sums only the output rows
`rows = (lo, hi)` the band owns (a window the `nhwc` kernel and the
`nchw` row-streaming kernel take; `*_window` counts), `reduce` adds the
other bands' sums, and the gate divides by the whole map's `hw`.  Pass 2
runs unchanged on the haloed band.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from enhanced_unet_tpu_torch.ops.kernels import build
from enhanced_unet_tpu_torch.utils.profiler import track_launches

LAUNCHES = track_launches({
    "mbconv_pass1": 0, "mbconv_pass2": 0,
    "mbconv_nhwc_pass1": 0, "mbconv_nhwc_pass2": 0,
    "mbconv_nhwc_expand_pass1": 0, "mbconv_nhwc_expand_pass2": 0,
    # pass 1 with a counted-rows window (a band of a spatially split map)
    "mbconv_pass1_window": 0, "mbconv_nhwc_pass1_window": 0})
_SOURCE = "mbconv"
_NHWC_SOURCE = "mbconv_nhwc"
NHWC_TILE_W = 32                   # csrc/mbconv_nhwc.cu TW
NHWC_MAX_C = 64                    # Cin (mid without an expand), Cout: multiples of 8 up to this
_EXPAND_SOURCE = "mbconv_nhwc_expand"
_NHWC_SLOTS = {}                   # (source, pass, C, Cout, TH, device) -> blocks the card holds


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


def _window(rows: Optional[Tuple[int, int]], h: int) -> Tuple[int, int]:
    """The counted output rows (lo, hi): `rows`, checked, or all h."""
    if rows is None:
        return 0, h
    lo, hi = int(rows[0]), int(rows[1])
    if not 0 <= lo <= hi <= h:
        raise ValueError(f"counted rows {rows} are not inside the {h} rows of the map")
    return lo, hi


def mbconv_pass1_plain(x: torch.Tensor, p: MBConvWeights,
                       rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Plain pass 1: per-image channel sums [N, mid] (fp32) over the output
    rows `rows` = (lo, hi) (default: all)."""
    lo, hi = _window(rows, x.shape[2])
    return _dw_silu_plain(x, p)[:, :, lo:hi].sum(dim=(2, 3))


def mbconv_pass2_plain(x: torch.Tensor, p: MBConvWeights, wpp: torch.Tensor,
                       residual: bool) -> torch.Tensor:
    """Plain pass 2: project with the gated weights wpp [N, mid, cout]."""
    y = _dw_silu_plain(x, p).to(x.dtype).float()
    o = torch.einsum("nmhw,nmc->nchw", y, wpp.float())
    o = o + p.bproj[None, :, None, None]
    if residual:
        o = o + x.float()
    return o.to(x.dtype)


def mbconv_infer_nchw_plain(x: torch.Tensor, p: MBConvWeights, *, residual: bool,
                            rows: Optional[Tuple[int, int]] = None,
                            reduce: Optional[Callable[[torch.Tensor], None]] = None,
                            hw: Optional[int] = None) -> torch.Tensor:
    """Plain version of the two-pass block: x [N,Cin,H,W] -> [N,Cout,H,W];
    `rows`, `reduce` and `hw` as for `mbconv_infer_nchw`."""
    sums = mbconv_pass1_plain(x, p, rows)
    if reduce is not None:
        reduce(sums)
    wpp = se_gated_projection(sums, p, x.shape[2] * x.shape[3] if hw is None else hw,
                              x.dtype)
    return mbconv_pass2_plain(x, p, wpp, residual)


def _lib() -> ctypes.CDLL:
    return bind_nchw(build.load(_SOURCE))


def bind_nchw(lib: ctypes.CDLL) -> ctypes.CDLL:
    """A library built from `csrc/mbconv.cu`, its C interface typed."""
    if lib.mbconv_pass1.restype is not ctypes.c_int:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.mbconv_pass1.argtypes = [vp] * 6 + [i] * 8 + [vp]
        lib.mbconv_pass1.restype = i
        lib.mbconv_pass2.argtypes = [vp] * 8 + [i] * 8 + [vp]
        lib.mbconv_pass2.restype = i
        lib.mbconv_nchw_tiles.argtypes = [i] * 4
        lib.mbconv_nchw_tiles.restype = i
    return lib


class _Launch(NamedTuple):
    """Checked device operands shared by the two passes."""
    lib: ctypes.CDLL
    x: torch.Tensor
    wexp: Optional[torch.Tensor]
    bexp: Optional[torch.Tensor]
    wdw: torch.Tensor
    bdw: torch.Tensor
    bf16: bool


def _prepare(x: torch.Tensor, p: MBConvWeights) -> _Launch:
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"mbconv takes bf16 or fp32, got {x.dtype}")
    if x.ndim != 4:
        raise ValueError(f"expected NCHW input, got shape {tuple(x.shape)}")
    build.check_grid(x.shape[0], x.shape[2], x.shape[3], "mbconv")
    cin = x.shape[1]
    mid = p.wdw.shape[0]
    expand = p.wexp is not None
    if p.wdw.shape != (mid, 3, 3) or (expand and p.wexp.shape != (mid, cin)) \
            or (not expand and mid != cin):
        raise ValueError("MBConv weights do not match the input channels")
    dev = x.device
    return _Launch(
        lib=_lib(), x=x.contiguous(),
        wexp=p.wexp.to(dev, x.dtype).contiguous() if expand else None,
        bexp=p.bexp.to(dev, torch.float32).contiguous() if expand else None,
        wdw=p.wdw.to(dev, x.dtype).contiguous(),
        bdw=p.bdw.to(dev, torch.float32).contiguous(),
        bf16=x.dtype == torch.bfloat16)


def mbconv_pass1(x: torch.Tensor, p: MBConvWeights,
                 rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Pass 1 on the card: per-image channel sums [N, mid] (fp32) over the
    output rows `rows` = (lo, hi) (default: all; a window only without an
    expand, on the row-streaming kernel, counted as `mbconv_pass1_window`).
    The kernel writes one partial sum per (image, tile, channel), the tiles
    as the library plans them; they are summed here in a fixed order."""
    a = _prepare(x, p)
    n, cin, h, w = a.x.shape
    mid = p.wdw.shape[0]
    lo, hi = _window(rows, h)
    if rows is not None and a.wexp is not None:
        raise ValueError("the tiled nchw pass 1 (a block with an expand) takes no "
                         "counted-rows window")
    tiles = a.lib.mbconv_nchw_tiles(h, w, int(a.wexp is not None), int(a.bf16))
    partial = torch.empty((n, tiles, mid), dtype=torch.float32, device=x.device)
    rc = a.lib.mbconv_pass1(build.ptr(a.x), build.ptr(a.wexp), build.ptr(a.bexp),
                            build.ptr(a.wdw), build.ptr(a.bdw), build.ptr(partial),
                            n, cin, mid, h, w, lo, hi, int(a.bf16), build.stream_ptr(x.device))
    build.check(rc, "mbconv pass 1 launch")
    LAUNCHES["mbconv_pass1" if rows is None else "mbconv_pass1_window"] += 1
    return partial.sum(dim=1)


def mbconv_pass2(x: torch.Tensor, p: MBConvWeights, wpp: torch.Tensor,
                 residual: bool) -> torch.Tensor:
    """Pass 2 on the card: [N, Cout, H, W] in x's dtype, contiguous."""
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
                            h, w, int(residual), int(a.bf16), build.stream_ptr(x.device))
    build.check(rc, "mbconv pass 2 launch")
    LAUNCHES["mbconv_pass2"] += 1
    return out


def variant_for(x: torch.Tensor, p: MBConvWeights) -> str:
    """The kernels that take this block, from shape and dtype alone:
    `"nhwc"` for bf16 with no expand, mid = Cin and Cout multiples of 8 up
    to 64; `"nhwc_expand"` for bf16 with an expand, Cin and Cout multiples
    of 8 up to 64 and mid a multiple of 8; `"nchw"` otherwise."""
    cin, mid, cout = x.shape[1], p.wdw.shape[0], p.wproj.shape[1]
    narrow = (cin % 8 == 0 and cin <= NHWC_MAX_C and cout % 8 == 0
              and cout <= NHWC_MAX_C)
    if x.dtype != torch.bfloat16 or not narrow:
        return "nchw"
    if p.wexp is None:
        return "nhwc" if cin == mid else "nchw"
    return "nhwc_expand" if mid % 8 == 0 else "nchw"


def _nhwc_lib() -> ctypes.CDLL:
    lib = build.load(_NHWC_SOURCE)
    if lib.mbconv_nhwc_pass1.restype is not ctypes.c_int:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.mbconv_nhwc_pass1.argtypes = [vp] * 4 + [i] * 7 + [vp] * 2
        lib.mbconv_nhwc_pass1.restype = i
        lib.mbconv_nhwc_pass2.argtypes = [vp] * 6 + [i] * 7 + [vp] * 2
        lib.mbconv_nhwc_pass2.restype = i
    return lib


def nhwc_tile_rows(n: int, h: int, w: int, slots16: int, slots8: int) -> int:
    """Output rows per tile of the `nhwc` kernels, 16 or 8, for an
    [n, h, w] grid on a card that holds `slots16` (`slots8`) blocks of the
    16-row (8-row) kernel at once.  A block's time goes with its rows, so
    a grid costs about its waves times its tile rows: 8 rows where that
    is less, else 16 (the halo read 1.20x, not 1.33x)."""
    def tiles(th):
        return n * -(-h // th) * -(-w // NHWC_TILE_W)

    cost16 = -(-tiles(16) // slots16) * 16
    cost8 = -(-tiles(8) // slots8) * 8
    return 8 if cost8 < cost16 else 16


def _expand_lib() -> ctypes.CDLL:
    lib = build.load(_EXPAND_SOURCE)
    if lib.mbconv_nhwc_expand_pass1.restype is not ctypes.c_int:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.mbconv_nhwc_expand_pass1.argtypes = [vp] * 6 + [i] * 6 + [vp] * 2
        lib.mbconv_nhwc_expand_pass1.restype = i
        lib.mbconv_nhwc_expand_pass2.argtypes = [vp] * 8 + [i] * 8 + [vp] * 2
        lib.mbconv_nhwc_expand_pass2.restype = i
    return lib


def _nhwc_slots(source: str, which: int, c: int, cout: int, th: int,
                device: torch.device) -> int:
    """Blocks of pass `which`'s kernel of `source` (`mbconv_nhwc` or
    `mbconv_nhwc_expand`, input channels c) the card holds at once
    (resident blocks per SM from the CUDA occupancy query, times the SMs),
    cached."""
    key = (source, which, c, cout, th, device)
    if key not in _NHWC_SLOTS:
        blocks = ctypes.c_int(0)
        if source == _EXPAND_SOURCE:
            lib, null = _expand_lib(), [None] * 6
            rc = (lib.mbconv_nhwc_expand_pass1(*null, 0, c, 0, 0, 0, th,
                                               ctypes.byref(blocks), None)
                  if which == 1 else
                  lib.mbconv_nhwc_expand_pass2(*null, None, None, 0, c, 0, cout, 0, 0,
                                               0, th, ctypes.byref(blocks), None))
        elif which == 1:
            rc = _nhwc_lib().mbconv_nhwc_pass1(None, None, None, None, 0, c, 0, 0, th, 0,
                                               0, ctypes.byref(blocks), None)
        else:
            rc = _nhwc_lib().mbconv_nhwc_pass2(None, None, None, None, None, None, 0, c,
                                               cout, 0, 0, 0, th, ctypes.byref(blocks),
                                               None)
        build.check(rc, f"{source} pass {which} occupancy")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _NHWC_SLOTS[key] = max(1, blocks.value) * sms
    return _NHWC_SLOTS[key]


def _tile_rows(source: str, which: int, xh: torch.Tensor, cout: int) -> int:
    n, h, w, c = xh.shape
    return nhwc_tile_rows(n, h, w, _nhwc_slots(source, which, c, cout, 16, xh.device),
                          _nhwc_slots(source, which, c, cout, 8, xh.device))


def _nhwc_prepare(x: torch.Tensor, p: MBConvWeights,
                  variant: str = "nhwc") -> torch.Tensor:
    """Checks for the `nhwc` or `nhwc_expand` kernels; x's NHWC view [N, H,
    W, C] (no copy for a channels_last x, one copy otherwise)."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the {variant} MBConv kernels take bf16, got {x.dtype}")
    if x.ndim != 4:
        raise ValueError(f"expected NCHW input, got shape {tuple(x.shape)}")
    build.check_grid(x.shape[0], x.shape[2], x.shape[3], f"mbconv {variant}")
    if variant_for(x, p) != variant:
        raise ValueError(f"the {variant} MBConv kernels do not take cin={x.shape[1]} "
                         f"mid={p.wdw.shape[0]} cout={p.wproj.shape[1]} "
                         f"expand={p.wexp is not None}")
    mid = p.wdw.shape[0]
    if p.wdw.shape != (mid, 3, 3) or (p.wexp is None and mid != x.shape[1]) or (
            p.wexp is not None and p.wexp.shape != (mid, x.shape[1])):
        raise ValueError("MBConv weights do not match the input channels")
    xh = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
    if not xh.is_contiguous() or xh.data_ptr() % 16:
        raise ValueError(f"the {variant} MBConv kernels need a 16-byte aligned "
                         "channels_last input")
    return xh


def mbconv_nhwc_pass1(x: torch.Tensor, p: MBConvWeights,
                      rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Pass 1 of the `nhwc` kernels: per-image channel sums [N, mid] (fp32)
    of NCHW x (channels_last memory read in place) over the output rows
    `rows` = (lo, hi) (default: all; with a window counted as
    `mbconv_nhwc_pass1_window`).  One partial sum per (image, channel,
    tile), summed here in a fixed order."""
    xh = _nhwc_prepare(x, p)
    n, h, w, c = xh.shape
    lo, hi = _window(rows, h)
    th = _tile_rows(_NHWC_SOURCE, 1, xh, c)
    partial = torch.empty((n, c, -(-h // th) * -(-w // NHWC_TILE_W)), dtype=torch.float32,
                          device=x.device)
    ptrs, _keep = _weight_operands(x, p, False)
    rc = _nhwc_lib().mbconv_nhwc_pass1(
        build.ptr(xh), *ptrs, build.ptr(partial), n, c, h, w, th, lo, hi, None,
        build.stream_ptr(x.device))
    build.check(rc, "mbconv_nhwc pass 1 launch")
    LAUNCHES["mbconv_nhwc_pass1" if rows is None else "mbconv_nhwc_pass1_window"] += 1
    return partial.sum(dim=2)


def mbconv_nhwc_pass2(x: torch.Tensor, p: MBConvWeights, wpp: torch.Tensor,
                      residual: bool) -> torch.Tensor:
    """Pass 2 of the `nhwc` kernels: [N, Cout, H, W] bf16, channels_last."""
    xh = _nhwc_prepare(x, p)
    n, h, w, c = xh.shape
    cout = p.wproj.shape[1]
    if residual and c != cout:
        raise ValueError("residual needs Cin == Cout")
    if wpp.shape != (n, c, cout):
        raise ValueError(f"gated weights must be [N, mid, Cout], got {tuple(wpp.shape)}")
    wpp = wpp.to(x.device, x.dtype).contiguous()
    out = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    ptrs, _keep = _weight_operands(x, p, False)
    rc = _nhwc_lib().mbconv_nhwc_pass2(
        build.ptr(xh), *ptrs, build.ptr(wpp),
        build.ptr(p.bproj.to(x.device, torch.float32).contiguous()), build.ptr(out),
        n, c, cout, h, w, int(residual), _tile_rows(_NHWC_SOURCE, 2, xh, cout), None,
        build.stream_ptr(x.device))
    build.check(rc, "mbconv_nhwc pass 2 launch")
    LAUNCHES["mbconv_nhwc_pass2"] += 1
    return out.permute(0, 3, 1, 2)


def _weight_operands(x: torch.Tensor, p: MBConvWeights, expand: bool) -> list:
    """The `nhwc` (wdw, bdw) or `nhwc_expand` (wexp, bexp, wdw, bdw) kernels'
    weight pointers on x's device, contiguous and 16-byte aligned (no copy
    for folded weights already in place)."""
    ts = ([p.wexp.to(x.device, x.dtype).contiguous(),
           p.bexp.to(x.device, torch.float32).contiguous()] if expand else []) + [
        p.wdw.to(x.device, x.dtype).contiguous(),
        p.bdw.to(x.device, torch.float32).contiguous()]
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("the nhwc MBConv kernels need 16-byte aligned weights")
    return [build.ptr(t) for t in ts], ts


def mbconv_nhwc_expand_pass1(x: torch.Tensor, p: MBConvWeights) -> torch.Tensor:
    """Pass 1 of the `nhwc_expand` kernels: per-image channel sums [N, mid]
    (fp32) of NCHW x (channels_last memory read in place).  One partial sum
    per (image, channel, tile), summed here in a fixed order."""
    xh = _nhwc_prepare(x, p, "nhwc_expand")
    n, h, w, c = xh.shape
    mid = p.wdw.shape[0]
    th = _tile_rows(_EXPAND_SOURCE, 1, xh, p.wproj.shape[1])
    partial = torch.empty((n, mid, -(-h // th) * -(-w // NHWC_TILE_W)),
                          dtype=torch.float32, device=x.device)
    ptrs, _keep = _weight_operands(x, p, True)
    rc = _expand_lib().mbconv_nhwc_expand_pass1(
        build.ptr(xh), *ptrs, build.ptr(partial), n, c, mid, h, w, th, None,
        build.stream_ptr(x.device))
    build.check(rc, "mbconv_nhwc_expand pass 1 launch")
    LAUNCHES["mbconv_nhwc_expand_pass1"] += 1
    return partial.sum(dim=2)


def mbconv_nhwc_expand_pass2(x: torch.Tensor, p: MBConvWeights, wpp: torch.Tensor,
                             residual: bool) -> torch.Tensor:
    """Pass 2 of the `nhwc_expand` kernels: [N, Cout, H, W] bf16,
    channels_last."""
    xh = _nhwc_prepare(x, p, "nhwc_expand")
    n, h, w, c = xh.shape
    mid, cout = p.wdw.shape[0], p.wproj.shape[1]
    if residual and c != cout:
        raise ValueError("residual needs Cin == Cout")
    if wpp.shape != (n, mid, cout):
        raise ValueError(f"gated weights must be [N, mid, Cout], got {tuple(wpp.shape)}")
    wpp = wpp.to(x.device, x.dtype).contiguous()
    out = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    ptrs, _keep = _weight_operands(x, p, True)
    rc = _expand_lib().mbconv_nhwc_expand_pass2(
        build.ptr(xh), *ptrs, build.ptr(wpp),
        build.ptr(p.bproj.to(x.device, torch.float32).contiguous()), build.ptr(out),
        n, c, mid, cout, h, w, int(residual), _tile_rows(_EXPAND_SOURCE, 2, xh, cout),
        None, build.stream_ptr(x.device))
    build.check(rc, "mbconv_nhwc_expand pass 2 launch")
    LAUNCHES["mbconv_nhwc_expand_pass2"] += 1
    return out.permute(0, 3, 1, 2)


def mbconv_infer_nchw(x: torch.Tensor, p: MBConvWeights, *, residual: bool,
                      rows: Optional[Tuple[int, int]] = None,
                      reduce: Optional[Callable[[torch.Tensor], None]] = None,
                      hw: Optional[int] = None) -> torch.Tensor:
    """Fused MBConv inference on NCHW input [N, Cin, H, W] (bf16 or fp32,
    any memory format).  CPU tensor: the plain version.  CUDA tensor: the
    two kernels of `variant_for(x, p)` with the SE gate between them, or an
    error for what they do not take.  The `nhwc` and `nhwc_expand` kernels
    return a channels_last result, the `nchw` kernels a contiguous one.

    On a band of a spatially split map: pass 1 sums only the output rows
    `rows` = (lo, hi) (the `nhwc` and the row-streaming `nchw` kernels; any
    other variant raises), `reduce(sums)` adds the other bands' sums in
    place, and the gate divides by `hw`, the whole map's pixels (default
    H * W).  Pass 2 computes every row of x."""
    if x.device.type == "cpu":
        return mbconv_infer_nchw_plain(x, p, residual=residual, rows=rows, reduce=reduce,
                                       hw=hw)
    hw = x.shape[2] * x.shape[3] if hw is None else hw
    variant = variant_for(x, p)
    if variant == "nchw":
        pass1, pass2 = mbconv_pass1, mbconv_pass2
    else:
        x = x.contiguous(memory_format=torch.channels_last)
        pass1, pass2 = ((mbconv_nhwc_pass1, mbconv_nhwc_pass2) if variant == "nhwc" else
                        (mbconv_nhwc_expand_pass1, mbconv_nhwc_expand_pass2))
    if rows is None:
        sums = pass1(x, p)
    elif variant == "nhwc_expand":
        raise ValueError("the nhwc_expand pass 1 takes no counted-rows window")
    else:
        sums = pass1(x, p, rows)
    if reduce is not None:
        reduce(sums)
    wpp = se_gated_projection(sums, p, hw, x.dtype)
    return pass2(x, p, wpp, residual)
