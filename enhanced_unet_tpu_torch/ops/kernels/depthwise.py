"""Depthwise convs with SiLU fused: CUDA kernels and their plain PyTorch
versions.  Two kernels for the benches (3x3 + bias on NCHW tensors) and one
for the serving path (dilated, BN folded, on NHWC memory).

- `dw3x3_bias_silu` replaces the Pallas kernels of
  `benchmarks/pallas_dw_variants.py::main` (`v1_kernel`, `v3_kernel`,
  `v4_kernel`; v2 runs v1's program): SiLU(depthwise 3x3 SAME, zero-padded,
  + fp32 bias), cast to bf16.
- `dw_rows_silu` replaces `_dw_only_kernel` of
  `benchmarks/pallas_mbconv_instr.py::main`, a row-only probe that is
  deliberately not a true convolution (see `dw_rows_silu_plain`).

Rounding points: the weights are rounded to bf16, the products and their
sum are fp32 (the TPU kernels round each product and partial sum to bf16),
the bias is fp32, and the SiLU output is cast to bf16.  These two take
bf16 only, as the TPU kernels do; the wrappers refuse any other dtype on
either device.  Weights in another dtype are cast on every call (one more
small kernel).

What bounds them on the H100: bytes (about 23 operations per element on 4
bytes moved in bf16, far below the card's bf16 ridge of about 295).  The
kernels (`csrc/depthwise.cu`) stream rows: one warp takes 256 columns of
one plane (8 a lane, one 16-byte vector) down a strip of output rows,
keeps a window of three input rows in registers and the next rows in
flight by `cp.async`, and takes the column neighbours from the adjacent
lanes by shuffles; each input row is read once a strip.  `dw_rows_silu`
slides the same window with the probe's row map.  Widths that are not a
multiple of 8 and tensors that do not start 16-byte aligned take the same
loop with 2-byte accesses; the kernel chooses from shape and alignment.
Nothing on the serving path calls these two kernels; the benches in
`enhanced_unet_tpu_torch/benchmarks/` do.

- `dw_dilated_bn_silu_nhwc` serves the eval-mode dilated MBConv blocks
  (`models/encoders.py` `MBConvBlock`: the DeepLab encoder's stages 5-6 at
  output stride 16): SiLU(depthwise k x k (3 or 5), stride 1, dilation d,
  zero padding d * (k // 2), BN folded into the weights, + fp32 shift) on
  channels_last tensors, bf16 or fp32, one cast of the output.  It replaces
  no Pallas kernel: the JAX package runs these blocks through XLA.  It was
  added because cuDNN's grouped direct kernel, which the dilation sends
  these convs to, ran about 50 times off the bytes bound at the serving
  shapes, between NHWC<->NCHW transforms, with a pad copy before it and BN
  and SiLU passes after it.  It is bytes-bound (about 50 operations an
  element on 4 bytes in bf16), so `csrc/depthwise.cu` reads each input
  element from device memory once (a haloed band of rows in shared memory,
  zero-filled at the borders, so no padded tensor is written) and writes
  each output once, neighbouring threads on neighbouring channels.
  `fold_dw_bn` folds the weights; `models/encoders.py` caches them.

Its rounding points: the folded weights are rounded to the compute dtype,
the products and their sum are fp32, the shift is fp32, and the SiLU output
is cast once.

- `dw3x3_bias_gelu_nhwc` serves SegFormer's Mix-FFN (`models/segformer.py`):
  GELU(depthwise 3x3, stride 1, zero padding 1, + the conv's bias as the
  fp32 shift), exact erf, on channels_last tensors: the same kernel body as
  `dw_dilated_bn_silu_nhwc` at dilation 1 with another epilogue, under a
  kernel name of its own (`dw3x3_gelu_nhwc_kernel`).  `fold_dw_bias` lays
  out its weights; the model caches them.  The same rounding points, the
  GELU's output cast once.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from enhanced_unet_tpu_torch.ops.kernels import build
from enhanced_unet_tpu_torch.ops.kernels.conv_fused import fold_bn_params
from enhanced_unet_tpu_torch.utils.profiler import track_launches

LAUNCHES = track_launches({"dw3x3_bias_silu": 0, "dw_rows_silu": 0,
                          "dw_dilated_bn_silu_nhwc": 0, "dw3x3_bias_gelu_nhwc": 0})
_SOURCE = "depthwise"
_INT_MAX = 2 ** 31 - 1


def _check(x: torch.Tensor, wdw: torch.Tensor, bdw: torch.Tensor) -> None:
    """What the kernels take, checked for CPU and CUDA tensors alike."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the depthwise kernels take bf16, got {x.dtype}")
    if x.ndim != 4:
        raise ValueError(f"expected NCHW input, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("the depthwise kernels take a contiguous NCHW tensor")
    n, c, h, w = x.shape
    if wdw.shape != (c, 3, 3) or bdw.shape != (c,):
        raise ValueError(f"weights must be [C,3,3] and [C] for C={c}, got "
                         f"{tuple(wdw.shape)} and {tuple(bdw.shape)}")
    if n * c > _INT_MAX or h * w > _INT_MAX:
        raise ValueError(f"shape {tuple(x.shape)} too large for the kernels")


def _silu_cast(acc: torch.Tensor, bdw: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    acc = acc + bdw.float()[None, :, None, None]
    return (acc * torch.sigmoid(acc)).to(dtype)


def dw3x3_bias_silu_plain(x: torch.Tensor, wdw: torch.Tensor,
                          bdw: torch.Tensor) -> torch.Tensor:
    """Plain version: x [N,C,H,W], wdw [C,3,3], bdw [C] -> [N,C,H,W] in x's
    dtype."""
    acc = F.conv2d(x.float(), wdw.to(x.dtype).float()[:, None], padding=1,
                   groups=x.shape[1])
    return _silu_cast(acc, bdw, x.dtype)


def dw_rows(h: int, bh: int) -> torch.Tensor:
    """The probe's row map [3, H]: the input row that tap row u reads for
    each output row.  For slab s (rows s*bh ... s*bh+bh-1), lo =
    max(s*bh - 1, 0); tap row u reads rows lo+u ... lo+u+bh-1, or the last
    bh rows of the image when those would run past it."""
    if bh <= 0 or h % bh:
        raise ValueError(f"bh={bh} must divide H={h}")
    rows = [[], [], []]
    for h0 in range(0, h, bh):
        lo = max(h0 - 1, 0)
        for u in range(3):
            first = lo + u if lo + u + bh <= h else h - bh
            rows[u].extend(range(first, first + bh))
    return torch.tensor(rows)


@functools.lru_cache(maxsize=None)
def _dw_rows_on(h: int, bh: int, device: torch.device) -> torch.Tensor:
    """`dw_rows` on `device`, copied there once: a copy from host memory
    waits for the device, so it stays out of repeated calls."""
    return dw_rows(h, bh).to(device)


def dw_rows_silu_plain(x: torch.Tensor, wdw: torch.Tensor, bdw: torch.Tensor,
                       bh: int) -> torch.Tensor:
    """Plain version of the row-only probe: SiLU(sum_u sum_v x[rows_u] *
    wdw[u, v] + bdw), where the three v taps of a row read the same columns
    (no column shift)."""
    rows = _dw_rows_on(x.shape[2], bh, x.device)
    w = wdw.to(x.dtype).float()
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for u in range(3):
        xu = x[:, :, rows[u], :].float()
        for v in range(3):
            acc = acc + xu * w[:, u, v][None, :, None, None]
    return _silu_cast(acc, bdw, x.dtype)


def _lib() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    if lib.dw3x3_bias_silu.restype is not ctypes.c_int:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.dw3x3_bias_silu.argtypes = [vp] * 4 + [i] * 4 + [vp]
        lib.dw3x3_bias_silu.restype = i
        lib.dw_rows_silu.argtypes = [vp] * 4 + [i] * 5 + [vp]
        lib.dw_rows_silu.restype = i
        lib.dw_dilated_bn_silu_nhwc.argtypes = [vp] * 4 + [i] * 7 + [vp]
        lib.dw_dilated_bn_silu_nhwc.restype = i
        lib.dw3x3_bias_gelu_nhwc.argtypes = [vp] * 4 + [i] * 5 + [vp]
        lib.dw3x3_bias_gelu_nhwc.restype = i
    return lib


def _operands(x: torch.Tensor, wdw: torch.Tensor, bdw: torch.Tensor):
    """Weights on x's device in the kernel's types, and the output."""
    return (wdw.to(x.device, torch.bfloat16).contiguous(),
            bdw.to(x.device, torch.float32).contiguous(),
            torch.empty_like(x))


def dw3x3_bias_silu(x: torch.Tensor, wdw: torch.Tensor,
                    bdw: torch.Tensor) -> torch.Tensor:
    """SiLU(depthwise 3x3 SAME (zero padding) + bias) of x [N,C,H,W] (bf16,
    contiguous), wdw [C,3,3], bdw [C] -> [N,C,H,W] bf16.
    CPU tensor: the plain version.  CUDA tensor: the kernel, or an error
    for what it does not take."""
    _check(x, wdw, bdw)
    if x.device.type == "cpu":
        return dw3x3_bias_silu_plain(x, wdw, bdw)
    w, b, out = _operands(x, wdw, bdw)
    n, c, h, width = x.shape
    rc = _lib().dw3x3_bias_silu(build.ptr(x), build.ptr(w), build.ptr(b),
                                build.ptr(out), n, c, h, width,
                                build.stream_ptr(x.device))
    build.check(rc, "dw3x3_bias_silu launch")
    LAUNCHES["dw3x3_bias_silu"] += 1
    return out


def dw_rows_silu(x: torch.Tensor, wdw: torch.Tensor, bdw: torch.Tensor,
                 bh: int) -> torch.Tensor:
    """The row-only depthwise probe (see `dw_rows_silu_plain`) of x
    [N,C,H,W] (bf16, contiguous) with row slabs of `bh` rows, which
    must divide H.  CPU tensor: the plain version.  CUDA tensor: the
    kernel, or an error for what it does not take."""
    _check(x, wdw, bdw)
    n, c, h, width = x.shape
    if bh <= 0 or h % bh:
        raise ValueError(f"bh={bh} must divide H={h}")
    if x.device.type == "cpu":
        return dw_rows_silu_plain(x, wdw, bdw, bh)
    w, b, out = _operands(x, wdw, bdw)
    rc = _lib().dw_rows_silu(build.ptr(x), build.ptr(w), build.ptr(b),
                             build.ptr(out), n, c, h, width, bh,
                             build.stream_ptr(x.device))
    build.check(rc, "dw_rows_silu launch")
    LAUNCHES["dw_rows_silu"] += 1
    return out


class DwFolded(NamedTuple):
    """A depthwise conv with its BN folded in (see `fold_dw_bn`)."""
    w: torch.Tensor                # [k, k, C] compute dtype (BN folded)
    shift: torch.Tensor            # [C] fp32


DILATED_KS = (3, 5)
MAX_DILATION = 4                   # csrc/depthwise.cu fits every map's tile up to this


def fold_dw_bn(weight: torch.Tensor, bn: Sequence[torch.Tensor], eps: float,
               dtype: torch.dtype) -> DwFolded:
    """Fold BN into a depthwise conv: weight [C, 1, k, k] (torch layout),
    bn = (gamma, beta, running_mean, running_var) -> weights [k, k, C] in
    `dtype` and the fp32 shift (`conv_fused.fold_bn_params`), as
    `mbconv.fold_mbconv_weights` folds K1's depthwise."""
    s, shift = fold_bn_params(*bn, eps=eps)
    w = (weight[:, 0] * s[:, None, None]).to(dtype).permute(1, 2, 0).contiguous()
    return DwFolded(w=w, shift=shift.float().contiguous())


def _check_dilated(x: torch.Tensor, p: DwFolded, dilation: int) -> None:
    """What the dilated kernel takes, checked for CPU and CUDA tensors alike."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the dilated depthwise kernel takes bf16 or fp32, got {x.dtype}")
    if p.w.dtype != x.dtype or p.shift.dtype != torch.float32:
        raise TypeError(f"weights must be in x's dtype {x.dtype} and the shift fp32, got "
                        f"{p.w.dtype} and {p.shift.dtype}")
    if x.ndim != 4:
        raise ValueError(f"expected a 4-D [N,C,H,W] input, got shape {tuple(x.shape)}")
    n, c, h, w = x.shape
    k = p.w.shape[0]
    if k not in DILATED_KS or p.w.shape != (k, k, c) or p.shift.shape != (c,):
        raise ValueError(f"weights must be [k,k,C] with k in {DILATED_KS} and the shift [C] "
                         f"for C={c}, got {tuple(p.w.shape)} and {tuple(p.shift.shape)}")
    if not (isinstance(dilation, int) and 1 <= dilation <= MAX_DILATION):
        raise ValueError(f"dilation must be an int in [1, {MAX_DILATION}], got {dilation!r}")
    if min(n, c, h, w) < 1 or n > build.MAX_GRID_Z or max(c, h, w) > _INT_MAX:
        raise ValueError(f"shape {tuple(x.shape)}: the kernel takes 1 to {build.MAX_GRID_Z} "
                         "images of at least one pixel and channel")
    if p.w.device != x.device or p.shift.device != x.device:
        raise ValueError(f"weights on {p.w.device} and {p.shift.device}, input on {x.device}")


def dw_dilated_bn_silu_nhwc_plain(x: torch.Tensor, p: DwFolded,
                                  dilation: int) -> torch.Tensor:
    """Plain version: x [N,C,H,W] -> SiLU(depthwise(x; p.w, dilation,
    zero padding dilation * (k // 2)) + p.shift), fp32 sums, cast to x's
    dtype."""
    k, c = p.w.shape[0], p.w.shape[2]
    acc = F.conv2d(x.float(), p.w.float().permute(2, 0, 1)[:, None],
                   padding=dilation * (k // 2), dilation=dilation, groups=c)
    return _silu_cast(acc, p.shift, x.dtype)


def dw_dilated_bn_silu_nhwc(x: torch.Tensor, p: DwFolded, dilation: int) -> torch.Tensor:
    """SiLU(depthwise k x k, stride 1, `dilation`, zero padding, BN folded
    (`fold_dw_bn`) + shift) of x [N,C,H,W], bf16 or fp32, with `p` in x's
    dtype on x's device.  CPU tensor: the plain version.  CUDA tensor: the
    kernel on NHWC memory (a channels_last x goes in without a copy; another
    layout is copied to channels_last first), a channels_last result; or an
    error for what it does not take."""
    _check_dilated(x, p, dilation)
    if x.device.type == "cpu":
        return dw_dilated_bn_silu_nhwc_plain(x, p, dilation)
    x = x.contiguous(memory_format=torch.channels_last)
    w, shift = p.w.contiguous(), p.shift.contiguous()
    out = torch.empty_like(x, memory_format=torch.channels_last)
    n, c, h, width = x.shape
    rc = _lib().dw_dilated_bn_silu_nhwc(
        build.ptr(x), build.ptr(w), build.ptr(shift), build.ptr(out), n, h, width, c,
        w.shape[0], dilation, int(x.dtype == torch.float32), build.stream_ptr(x.device))
    build.check(rc, "dw_dilated_bn_silu_nhwc launch")
    LAUNCHES["dw_dilated_bn_silu_nhwc"] += 1
    return out


def fold_dw_bias(weight: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype) -> DwFolded:
    """A 3x3 depthwise conv's weight [C, 1, 3, 3] (torch layout) and bias [C]
    as `dw3x3_bias_gelu_nhwc` takes them: weights [3, 3, C] in `dtype`, the
    bias as the fp32 shift."""
    return DwFolded(w=weight[:, 0].to(dtype).permute(1, 2, 0).contiguous(),
                    shift=bias.float().contiguous())


def _check_gelu(x: torch.Tensor, p: DwFolded) -> None:
    _check_dilated(x, p, 1)
    if p.w.shape[0] != 3:
        raise ValueError(f"the GELU kernel takes 3x3 weights, got {tuple(p.w.shape)}")


def dw3x3_bias_gelu_nhwc_plain(x: torch.Tensor, p: DwFolded) -> torch.Tensor:
    """Plain version: x [N,C,H,W] -> GELU(depthwise 3x3(x; p.w, zero
    padding 1) + p.shift), exact erf, fp32 sums, cast to x's dtype."""
    acc = F.conv2d(x.float(), p.w.float().permute(2, 0, 1)[:, None], padding=1,
                   groups=p.w.shape[2])
    return F.gelu(acc + p.shift.float()[None, :, None, None]).to(x.dtype)


def dw3x3_bias_gelu_nhwc(x: torch.Tensor, p: DwFolded) -> torch.Tensor:
    """GELU(depthwise 3x3, stride 1, zero padding 1, + shift) of x [N,C,H,W],
    bf16 or fp32, with `p` (`fold_dw_bias`) in x's dtype on x's device.  CPU
    tensor: the plain version.  CUDA tensor: the kernel on NHWC memory (a
    channels_last x goes in without a copy; another layout is copied to
    channels_last first), a channels_last result; or an error for what it
    does not take."""
    _check_gelu(x, p)
    if x.device.type == "cpu":
        return dw3x3_bias_gelu_nhwc_plain(x, p)
    x = x.contiguous(memory_format=torch.channels_last)
    w, shift = p.w.contiguous(), p.shift.contiguous()
    out = torch.empty_like(x, memory_format=torch.channels_last)
    n, c, h, width = x.shape
    rc = _lib().dw3x3_bias_gelu_nhwc(
        build.ptr(x), build.ptr(w), build.ptr(shift), build.ptr(out), n, h, width, c,
        int(x.dtype == torch.float32), build.stream_ptr(x.device))
    build.check(rc, "dw3x3_bias_gelu_nhwc launch")
    LAUNCHES["dw3x3_bias_gelu_nhwc"] += 1
    return out
