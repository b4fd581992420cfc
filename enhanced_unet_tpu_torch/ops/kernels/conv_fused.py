"""Fused 3x3 conv + BatchNorm (inference) + ReLU: CUDA kernels and their
plain PyTorch version.

Replaces `enhanced_unet_tpu/ops/pallas/conv_fused.py::fused_conv3x3_bn_relu`
(the Pallas `_kernel`).  It computes an NHWC 3x3 SAME stride-1 conv summed in
fp32, then `y * scale + shift` (BN and any conv bias folded in by
`fold_bn_params`), an optional ReLU, and a cast to the input dtype.

What bounds it on the H100: operations at the wide layers, bytes at the
narrow ones.  In bf16 the fusion head's 256->128 and 128->64 layers do about
770 and 380 FLOPs per byte they must move, above the card's bf16 ridge of
about 295, so only `wgmma` at the tensor cores' full rate approaches their
bound, and the tile must keep small what it re-reads per output pixel: the
weights from L2 (9 * Cin * N * 2 / M bytes) and the wgmma operands from
shared memory.  The 6->256 entry layer does about 53 and is bound by the
bytes of its output, as are the 16..48-channel decoder layers.
`csrc/conv3x3_bn_act.cu` holds four kernels, chosen by shape alone
(`variant_for`):

- `wgmma` (bf16, Cin and Cout multiples of 8): a persistent,
  warp-specialised implicit GEMM.  A TMA producer fills a ring of weight
  stages (one channel chunk of one tap each) and a double-buffered haloed
  input tile whose out-of-range pixels and channels TMA fills with zeros,
  running ahead into the next tile; two consumer warpgroups load their
  activations with `ldmatrix` at tap-shifted pixels (the three taps of a
  column sharing fragment rows) and run `wgmma` against the weights in
  shared memory; 128 to 512 output pixels by all of Cout (up to 128) per
  tile, 16- to 64-channel chunks (`wgmma_tile`); each warp stages its
  output rows and writes them with TMA stores.
- `smallc` (bf16, Cin <= 7): 64 pixels of one image row per tile, their
  haloed input rows read coalesced, the 3x3xCin patch packed into one K of
  64, four `wgmma` k16 steps per 64 output channels, TMA stores: aimed at
  the output's byte bound.
- `mma` (bf16, every other shape): `mma.sync.m16n8k16`, synchronous loads.
- `f32`: CUDA cores (the tensor cores would round fp32 operands to TF32).

Weights are packed once (`pack_conv3x3`: cast, `[Cout][3][3][Cin]`
permute, the small-Cin K packing, fp32 scale/shift), and
`fused_conv3x3_bn_relu_packed` launches with the packed weights;
`models.blocks.conv_bn_act` keeps them on the module.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from enhanced_unet_tpu_torch.ops.kernels import build

VARIANTS = ("wgmma", "smallc", "mma", "f32")
LAUNCHES = {f"conv3x3_bn_act_{v}": 0 for v in VARIANTS}
_SOURCE = "conv3x3_bn_act"
SMALLC_K = 64              # the small-Cin kernel's packed K: 9 * Cin <= 64
SMALLC_MAX_CIN = SMALLC_K // 9
SMALLC_COUT_STEP = 64      # its weights' Cout, padded to a multiple of this


def fold_bn_params(gamma: torch.Tensor, beta: torch.Tensor,
                   mean: torch.Tensor, var: torch.Tensor, eps: float = 1e-5,
                   conv_bias: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """BatchNorm inference params -> (scale, shift) with
    gamma*(conv+bias-mean)/sqrt(var+eps)+beta == conv*scale + shift."""
    inv = gamma * torch.rsqrt(var + eps)
    shift = beta - mean * inv
    if conv_bias is not None:
        shift = shift + conv_bias * inv
    return inv, shift


def fused_conv3x3_bn_relu_plain(x: torch.Tensor, w: torch.Tensor,
                                scale: torch.Tensor, shift: torch.Tensor,
                                relu: bool = True) -> torch.Tensor:
    """Plain version: x [N,H,W,Cin], w [3,3,Cin,Cout] (HWIO) -> [N,H,W,Cout]
    in x's dtype.  Weights are rounded to x's dtype; sums are fp32."""
    xf = x.permute(0, 3, 1, 2).float()
    wf = w.to(x.dtype).float().permute(3, 2, 0, 1)
    y = F.conv2d(xf, wf, padding=1)
    y = y * scale.float()[None, :, None, None] + shift.float()[None, :, None, None]
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype).permute(0, 2, 3, 1)


def variant_for(cin: int, cout: int, dtype: torch.dtype) -> str:
    """The kernel that takes a conv of this shape and dtype."""
    if dtype == torch.float32:
        return "f32"
    if cout % 8 == 0 and cin <= SMALLC_MAX_CIN:
        return "smallc"
    if cout % 8 == 0 and cin % 8 == 0:
        return "wgmma"
    return "mma"


@dataclass(frozen=True)
class PackedConv3x3:
    """Weights of one conv3x3+BN layer as the kernels read them.

    `w` [Cout,3,3,Cin] (OHWI) in the compute dtype: the wgmma, mma and f32
    kernels' layout, K-contiguous as the NHWC activations are; `wk`
    [Cout_pad, 64], the small-Cin kernel's packed K (k = (3*dy + dx) * Cin
    + ci, zeros past 9 * Cin and Cout), else None; `scale`/`shift` [Cout]
    fp32."""

    w: torch.Tensor
    wk: Optional[torch.Tensor]
    scale: torch.Tensor
    shift: torch.Tensor
    variant: str

    @property
    def cin(self) -> int:
        return self.w.shape[3]

    @property
    def cout(self) -> int:
        return self.w.shape[0]


def pack_conv3x3(w: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                 dtype: torch.dtype, device) -> PackedConv3x3:
    """w [3,3,Cin,Cout] (HWIO), scale/shift [Cout] (BN folded) -> the
    packed weights for a `dtype` input on `device`, made once."""
    if w.ndim != 4 or w.shape[:2] != (3, 3):
        raise ValueError(f"w must be [3,3,Cin,Cout], got {tuple(w.shape)}")
    cin, cout = w.shape[2], w.shape[3]
    if scale.shape != (cout,) or shift.shape != (cout,):
        raise ValueError("scale/shift must be [Cout]")
    variant = variant_for(cin, cout, dtype)
    with torch.inference_mode(False), torch.no_grad():
        w_ohwi = w.detach().to(device=device, dtype=dtype).permute(3, 0, 1, 2).contiguous()
        packed_k = None
        if variant == "smallc":
            cout_pad = -(-cout // SMALLC_COUT_STEP) * SMALLC_COUT_STEP
            packed_k = F.pad(w_ohwi.reshape(cout, 9 * cin),
                             (0, SMALLC_K - 9 * cin, 0, cout_pad - cout)).contiguous()
        return PackedConv3x3(
            w=w_ohwi, wk=packed_k,
            scale=scale.detach().to(device=device, dtype=torch.float32).contiguous(),
            shift=shift.detach().to(device=device, dtype=torch.float32).contiguous(),
            variant=variant)


def _lib() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    for v in VARIANTS:
        fn = getattr(lib, f"conv3x3_bn_act_{v}")
        if fn.restype is not ctypes.c_int:
            n_int = 7 if v == "smallc" else 6   # N, H, W, Cin, Cout, [cout_pad,] relu
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * n_int + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    fn = lib.conv3x3_bn_act_wgmma_tile
    if fn.restype is not ctypes.c_int:
        fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 3
        fn.restype = ctypes.c_int
    return lib


def wgmma_tile(n: int, h: int, w: int, cin: int, cout: int) -> Tuple[int, int, int]:
    """The wgmma kernel's tile for an [n,h,w,cin]->cout conv on the current
    card: (output channels, m64 tiles per warpgroup, input channels per
    chunk); the pixel tile is 8 * m64 tiles rows by 16 columns."""
    out = [ctypes.c_int() for _ in range(3)]
    rc = _lib().conv3x3_bn_act_wgmma_tile(n, h, w, cin, cout, *map(ctypes.byref, out))
    build.check(rc, "conv3x3_bn_act_wgmma_tile")
    return out[0].value, out[1].value, out[2].value


def launch(variant: str, x: torch.Tensor, packed: PackedConv3x3,
           relu: bool) -> torch.Tensor:
    """Launch `variant`'s kernel on a checked CUDA input (no checks here)."""
    n, h, width, cin = x.shape
    cout = packed.cout
    out = torch.empty((n, h, width, cout), dtype=x.dtype, device=x.device)
    fn = getattr(_lib(), f"conv3x3_bn_act_{variant}")
    head = (build.ptr(x), build.ptr(packed.wk if variant == "smallc" else packed.w),
            build.ptr(packed.scale), build.ptr(packed.shift), build.ptr(out),
            n, h, width, cin, cout)
    extra = (packed.wk.shape[0],) if variant == "smallc" else ()
    rc = fn(*head, *extra, int(relu), build.stream_ptr(x.device))
    build.check(rc, f"conv3x3_bn_act_{variant} launch")
    LAUNCHES[f"conv3x3_bn_act_{variant}"] += 1
    return out


def fused_conv3x3_bn_relu_packed(x: torch.Tensor, packed: PackedConv3x3,
                                 relu: bool = True) -> torch.Tensor:
    """x [N,H,W,Cin] contiguous, bf16 or fp32, `packed` from `pack_conv3x3`
    for x's dtype and device -> [N,H,W,Cout] in x's dtype.  CPU tensor: the
    plain version.  CUDA tensor: the kernel `packed.variant`, or an error
    for what it does not take."""
    if x.device.type == "cpu":
        return fused_conv3x3_bn_relu_plain(x, packed.w.permute(1, 2, 3, 0),
                                           packed.scale, packed.shift, relu)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"conv3x3_bn_act takes bf16 or fp32, got {x.dtype}")
    if packed.w.dtype != x.dtype:
        raise TypeError(f"weights packed for {packed.w.dtype}, input is {x.dtype}")
    if packed.w.device != x.device:
        raise ValueError(f"weights packed on device {packed.w.device}, input on {x.device}")
    if x.ndim != 4 or x.shape[3] != packed.cin:
        raise ValueError(f"bad shapes x {tuple(x.shape)} for Cin {packed.cin}")
    if not x.is_contiguous():
        raise ValueError("conv3x3_bn_act takes a contiguous NHWC input")
    build.check_grid(x.shape[0], x.shape[1], x.shape[2], "conv3x3_bn_act")
    if packed.variant == "wgmma" and x.data_ptr() % 16:
        raise ValueError("the wgmma kernel needs a 16-byte aligned input")
    return launch(packed.variant, x, packed, relu)


def fused_conv3x3_bn_relu(x: torch.Tensor, w: torch.Tensor,
                          scale: torch.Tensor, shift: torch.Tensor,
                          relu: bool = True) -> torch.Tensor:
    """x [N,H,W,Cin] bf16 or fp32, w [3,3,Cin,Cout], scale/shift [Cout] ->
    [N,H,W,Cout] in x's dtype, packing the weights on every call.  CPU
    tensor: the plain version.  CUDA tensor: the kernel, or an error for
    what it does not take."""
    if x.device.type == "cpu":
        return fused_conv3x3_bn_relu_plain(x, w, scale, shift, relu)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"conv3x3_bn_act takes bf16 or fp32, got {x.dtype}")
    if x.ndim != 4 or w.shape[:2] != (3, 3) or w.shape[2] != x.shape[3]:
        raise ValueError(f"bad shapes x {tuple(x.shape)} w {tuple(w.shape)}")
    return fused_conv3x3_bn_relu_packed(
        x, pack_conv3x3(w, scale, shift, x.dtype, x.device), relu)
