"""Fused 3x3 conv + BatchNorm (inference) + ReLU: CUDA kernel and its plain
PyTorch version.

Replaces `enhanced_unet_tpu/ops/pallas/conv_fused.py::fused_conv3x3_bn_relu`
(the Pallas `_kernel`).  It computes an NHWC 3x3 SAME stride-1 conv summed in
fp32, then `y * scale + shift` (BN and any conv bias folded in by
`fold_bn_params`), an optional ReLU, and a cast to the input dtype.

What bounds it on the H100: operations at the wide layers, bytes at the
narrow one.  In bf16 the fusion head's 256->128 and 128->64 layers do about
770 and 380 FLOPs per byte they must move, above the card's bf16 ridge of
about 295, so only the tensor cores can approach their bound; its 6->256
entry layer does about 53 and is bound by the bytes of its output.  The
kernel (`csrc/conv3x3_bn_act.cu`) is an implicit GEMM kept simple for a
first port.  Each block stages one haloed input tile and the chunk's nine
tap weights in shared memory and reads all nine taps from that tile, so
unlike the TPU wrapper no shifted copies of the input are written to device
memory; the BN/ReLU epilogue is fused.  In bf16 the products run on the
tensor cores (`mma.sync.m16n8k16`, fp32 accumulators), with one synchronous
load per 16-channel chunk and no pipelining; in fp32 they run on CUDA
cores, since the tensor cores would round fp32 operands to TF32.  What the
bf16 kernel lacks against its bound: loads overlapped with the products
(`cp.async` or TMA), and `wgmma`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from enhanced_unet_tpu_torch.ops.kernels import build

LAUNCHES = {"conv3x3_bn_act": 0}
_SOURCE = "conv3x3_bn_act"


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


def _lib() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    fn = lib.conv3x3_bn_act
    if fn.restype is not ctypes.c_int:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def fused_conv3x3_bn_relu(x: torch.Tensor, w: torch.Tensor,
                          scale: torch.Tensor, shift: torch.Tensor,
                          relu: bool = True) -> torch.Tensor:
    """x [N,H,W,Cin] bf16 or fp32, w [3,3,Cin,Cout], scale/shift [Cout] ->
    [N,H,W,Cout] in x's dtype.  CPU tensor: the plain version.  CUDA tensor:
    the kernel, or an error for what it does not take."""
    if x.device.type == "cpu":
        return fused_conv3x3_bn_relu_plain(x, w, scale, shift, relu)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"conv3x3_bn_act takes bf16 or fp32, got {x.dtype}")
    if x.ndim != 4 or w.shape[:2] != (3, 3) or w.shape[2] != x.shape[3]:
        raise ValueError(f"bad shapes x {tuple(x.shape)} w {tuple(w.shape)}")
    n, h, width, cin = x.shape
    cout = w.shape[3]
    if scale.shape != (cout,) or shift.shape != (cout,):
        raise ValueError("scale/shift must be [Cout]")
    x = x.contiguous()
    # [Cout, 3, 3, Cin]: the reduction dimension contiguous, as in x
    wk = w.to(device=x.device, dtype=x.dtype).permute(3, 0, 1, 2).contiguous()
    sc = scale.to(device=x.device, dtype=torch.float32).contiguous()
    sh = shift.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty((n, h, width, cout), dtype=x.dtype, device=x.device)
    rc = _lib().conv3x3_bn_act(
        build.ptr(x), build.ptr(wk), build.ptr(sc), build.ptr(sh),
        build.ptr(out), n, h, width, cin, cout, int(relu),
        int(x.dtype == torch.bfloat16), build.stream_ptr(x.device))
    build.check(rc, "conv3x3_bn_act launch")
    LAUNCHES["conv3x3_bn_act"] += 1
    return out
