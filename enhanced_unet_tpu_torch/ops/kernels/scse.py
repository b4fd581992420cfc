"""scSE over a list of channel parts: a CUDA kernel and its plain PyTorch
version.

`scse_parts(parts, up, weights)` is smp's `SCSEModule` (the JAX package's
`models/blocks.py` `SCSEBlock`) applied to the channel concatenation of
`parts`, the first read through a nearest 2x upsample when `up`: the UNet++
decoder's attention blocks (`models/enhanced_unet.py` `NestedBlock`), whose
input is the upsampled node below, the dense nodes of its level and the
encoder feature.  On a card the concatenation and the upsample are never
formed: `csrc/scse.cu` reads each part where it lies, sums the channels
(one read), runs the channel gate (one block an image) and writes the gated
output once (a second read), as one channels_last `[N, C, H, W]` tensor.
See the source for the design and what bounds it.

It replaces no Pallas kernel; its counterpart in the JAX package is
`models/packed_blocks.py` `PackedSCSEMulti` (the gating pass over a parts
list, compiled by XLA).  The kernel's rounding points are the JAX
package's in bf16: the mean rounded to bf16, each 1x1 conv's fp32 sum
rounded to bf16 and its bias added in bf16, the sigmoids rounded to bf16,
then bf16(bf16(x * g) + bf16(x * s)); in fp32 it rounds nowhere.  The
plain version is the stock sequence of PyTorch calls (`models/blocks.py`
`SCSEBlock` on the concatenation), with each part's mean taken over the
part (the upsampled part's over its source); it takes bf16 or fp32.

The kernel takes 1 to `MAX_PARTS` parts of one dtype, bf16 or fp32, with
weights of that dtype, channels_last, each starting 16-byte aligned, with
a multiple of 8 channels each and at most `MAX_CHANNELS` in all; the
wrapper raises for anything else on a card: nothing falls back.  A call
launches three kernels and counts once in `LAUNCHES`.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from enhanced_unet_tpu_torch.ops.kernels import build
from enhanced_unet_tpu_torch.ops.resize import upsample2x_nearest_nchw
from enhanced_unet_tpu_torch.utils.profiler import track_launches

LAUNCHES = track_launches({"scse_parts": 0})
_SOURCE = "scse"

MAX_PARTS = 8                    # csrc/scse.cu MAX_PARTS
MAX_CHANNELS = 1024              # 32 lanes x 4 vectors of 8 channels a pixel
_ESIZE = {torch.bfloat16: 2, torch.float32: 4}   # the kernel's dtypes, by element size
_THREADS = 256                   # csrc/scse.cu NT
_SMS = 132                       # the H100's SMs: a grid of fewer than 4 blocks each is cut finer
_MIN_BLOCKS = 4 * _SMS
_GROUPS = (1, 2, 4, 8, 16, 32)   # lanes a pixel in the apply pass
_MAX_VECTORS = 4                 # 8-channel vectors a lane in the apply pass


class ScseWeights(NamedTuple):
    """An `SCSEBlock`'s three 1x1 convs in the compute dtype (`fold_scse`)."""
    w1: torch.Tensor             # [mid, C]  cSE squeeze
    b1: torch.Tensor             # [mid]
    w2: torch.Tensor             # [C, mid]  cSE excite
    b2: torch.Tensor             # [C]
    ws: torch.Tensor             # [C]       sSE
    bs: torch.Tensor             # [1]


def fold_scse(squeeze: nn.Conv2d, excite: nn.Conv2d, spatial: nn.Conv2d,
              dtype: torch.dtype) -> ScseWeights:
    """The cSE's two 1x1 convs and the sSE's C -> 1 conv (each with its
    bias) cast to `dtype` and laid out as matrices, as `scse_parts` takes
    them."""
    def mat(t):
        return t.reshape(t.shape[0], -1).to(dtype).contiguous()

    return ScseWeights(mat(squeeze.weight), squeeze.bias.to(dtype).contiguous(),
                       mat(excite.weight), excite.bias.to(dtype).contiguous(),
                       mat(spatial.weight)[0].contiguous(), spatial.bias.to(dtype).contiguous())


def _map_size(parts: Sequence[torch.Tensor], up: bool):
    n, _, h, w = parts[0].shape
    return n, (2 * h if up else h), (2 * w if up else w)


def _check(parts: Sequence[torch.Tensor], up: bool, p: ScseWeights) -> None:
    """What both versions take, checked for CPU and CUDA tensors alike."""
    if not parts:
        raise ValueError("scse_parts takes at least one part")
    x0 = parts[0]
    if x0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x0.device}")
    if any(t.ndim != 4 for t in parts):
        raise ValueError(f"parts must be [N,C,H,W], got {[tuple(t.shape) for t in parts]}")
    n, h, w = _map_size(parts, up)
    for t in parts[1:]:
        if (t.shape[0], t.shape[2], t.shape[3]) != (n, h, w):
            raise ValueError(f"every part after the first must be [{n},C,{h},{w}] "
                             f"(up={up}), got {tuple(t.shape)}")
    if any(t.device != x0.device or t.dtype != x0.dtype for t in parts):
        raise ValueError("the parts must share one device and one dtype")
    c = sum(t.shape[1] for t in parts)
    mid = p.w1.shape[0]
    if (p.w1.shape != (mid, c) or p.b1.shape != (mid,) or p.w2.shape != (c, mid)
            or p.b2.shape != (c,) or p.ws.shape != (c,) or p.bs.shape != (1,)):
        raise ValueError(f"weights for {c} channels expected, got "
                         f"{[tuple(t.shape) for t in p]}")
    if any(t.device != x0.device for t in p):
        raise ValueError(f"weights must lie on the parts' device {x0.device}")


def _kernel_refusal(parts: Sequence[torch.Tensor], up: bool, p: ScseWeights):
    """Why the kernel does not take these parts and weights, or None."""
    if len(parts) > MAX_PARTS:
        return f"the kernel takes 1 to {MAX_PARTS} parts"
    if parts[0].dtype not in _ESIZE or any(t.dtype != parts[0].dtype for t in p):
        return "the kernel takes bf16 or fp32 parts with weights of their dtype"
    if not all(t.is_contiguous(memory_format=torch.channels_last) for t in parts):
        return "the kernel takes channels_last parts"
    if any(t.data_ptr() % 16 for t in parts):
        return "the kernel takes parts that start 16-byte aligned"
    if any(t.shape[1] % 8 for t in parts) or sum(t.shape[1] for t in parts) > MAX_CHANNELS:
        return f"the kernel takes parts of a multiple of 8 channels, {MAX_CHANNELS} in all"
    n, h, w = _map_size(parts, up)
    if n > build.MAX_GRID_Z or h * w >= 2 ** 31 - 2 ** 16:
        return f"a batch of {n} maps of {h} x {w} is beyond the kernel's grid"
    return None


class Plan(NamedTuple):
    """A call's geometry (csrc/scse.cu): the sums pass's bands of `rows`
    output rows (`chunks` of them), the apply pass's `group` lanes and
    `vectors` 16-byte vectors a lane at a pixel, over runs of `pixels`."""
    rows: int
    chunks: int
    group: int
    vectors: int
    pixels: int


def plan(n: int, h: int, w: int, channels: Sequence[int]) -> Plan:
    """Bands of about 2048 pixels (an even number of rows), cut finer while
    the sums pass would have fewer than 4 blocks an SM; the fewest idle
    lanes for the apply pass (ties: more vectors a lane, fewer shuffles),
    and runs of 4 steps of the block's groups, cut finer likewise."""
    rows = max(2, (2048 // w) // 2 * 2)
    while rows > 2 and n * len(channels) * -(-h // rows) < _MIN_BLOCKS:
        rows = max(2, rows // 4 * 2)
    v = sum(channels) // 8
    group, vectors = min(((g, -(-v // g)) for g in _GROUPS if -(-v // g) <= _MAX_VECTORS),
                         key=lambda gk: (gk[0] * gk[1], -gk[1]))
    step = (_THREADS // group) * (2 if vectors <= 2 else 1)
    steps = 4
    while steps > 1 and n * -(-(h * w) // (step * steps)) < _MIN_BLOCKS:
        steps //= 2
    return Plan(rows, -(-h // rows), group, vectors, step * steps)


def scse_parts_plain(parts: Sequence[torch.Tensor], up: bool, p: ScseWeights) -> torch.Tensor:
    """Plain version: the stock sequence of `SCSEBlock` on the channel
    concatenation of `parts` (the first upsampled 2x, nearest, when `up`),
    each part's mean over its own pixels, in the weights' dtype."""
    dt = p.ws.dtype
    s = torch.cat([t.mean(dim=(2, 3), keepdim=True) for t in parts], dim=1)
    s = torch.relu(F.conv2d(s.to(dt), p.w1[:, :, None, None], p.b1))
    s = F.conv2d(s, p.w2[:, :, None, None], p.b2)
    x0 = upsample2x_nearest_nchw(parts[0]) if up else parts[0]
    x = torch.cat([x0, *parts[1:]], dim=1) if len(parts) > 1 else x0
    t = F.conv2d(x.to(dt), p.ws[None, :, None, None], p.bs)
    return x * torch.sigmoid(s) + x * torch.sigmoid(t)


def _lib() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    if lib.scse_parts.restype is not ctypes.c_int:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.scse_parts.argtypes = ([vp, vp] + [i] * 6 + [vp] * 4 + [i] + [vp] * 3 + [i] * 2
                                   + [vp] + [i] * 3 + [vp, vp])
        lib.scse_parts.restype = i
    return lib


def scse_parts(parts: Sequence[torch.Tensor], up: bool, p: ScseWeights) -> torch.Tensor:
    """scSE of the channel concatenation of `parts` ([N, C_i, H, W], the
    first [N, C_0, H/2, W/2] read through a nearest 2x upsample when `up`)
    with the weights `p` (`fold_scse`) -> [N, sum C_i, H, W].  CPU tensors:
    the plain version (bf16 or fp32).  CUDA tensors: the kernel, a
    channels_last result in the parts' dtype; or an error for what it does
    not take."""
    parts: List[torch.Tensor] = list(parts)
    _check(parts, up, p)
    if parts[0].device.type == "cpu":
        return scse_parts_plain(parts, up, p)
    why = _kernel_refusal(parts, up, p)
    if why is not None:
        raise ValueError(f"scse_parts: {why}")
    n, h, w = _map_size(parts, up)
    channels = [t.shape[1] for t in parts]
    c, dev = sum(channels), parts[0].device
    pl = plan(n, h, w, channels)
    dt = parts[0].dtype
    partial = torch.empty(n, pl.chunks, c, dtype=torch.float32, device=dev)
    gates = torch.empty(n, c, dtype=dt, device=dev)
    out = torch.empty((n, c, h, w), dtype=dt, device=dev, memory_format=torch.channels_last)
    ptrs = (ctypes.c_void_p * len(parts))(*[t.data_ptr() for t in parts])
    chans = (ctypes.c_int * len(parts))(*channels)
    w1, b1, w2, b2, ws, bs = (t.contiguous() for t in p)
    rc = _lib().scse_parts(
        ptrs, chans, len(parts), int(up), _ESIZE[dt], n, h, w, build.ptr(w1), build.ptr(b1),
        build.ptr(w2), build.ptr(b2), w1.shape[0], build.ptr(ws), build.ptr(bs),
        build.ptr(partial), pl.rows, pl.chunks, build.ptr(gates), pl.group, pl.vectors,
        pl.pixels, build.ptr(out), build.stream_ptr(dev))
    build.check(rc, "scse_parts launch")
    LAUNCHES["scse_parts"] += 1
    return out
