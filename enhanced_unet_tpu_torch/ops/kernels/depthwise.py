"""Depthwise 3x3 + bias + SiLU on NCHW tensors: CUDA kernels and their plain
PyTorch versions.

- `dw3x3_bias_silu` replaces the Pallas kernels of
  `benchmarks/pallas_dw_variants.py::main` (`v1_kernel`, `v3_kernel`,
  `v4_kernel`; v2 runs v1's program): SiLU(depthwise 3x3 SAME, zero-padded,
  + fp32 bias), cast to bf16.
- `dw_rows_silu` replaces `_dw_only_kernel` of
  `benchmarks/pallas_mbconv_instr.py::main`, a row-only probe that is
  deliberately not a true convolution (see `dw_rows_silu_plain`).

Rounding points: the weights are rounded to bf16, the products and their
sum are fp32 (the TPU kernels round each product and partial sum to bf16),
the bias is fp32, and the SiLU output is cast to bf16.  The kernels take
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
Nothing on the serving path calls these kernels; the benches in
`enhanced_unet_tpu_torch/benchmarks/` do.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from enhanced_unet_tpu_torch.ops.kernels import build

LAUNCHES = {"dw3x3_bias_silu": 0, "dw_rows_silu": 0}
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
