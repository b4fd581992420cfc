"""Identity copy of a tensor: CUDA kernel and its plain PyTorch version.

Replaces the Pallas copy kernels of `benchmarks/pallas_mbconv_instr.py::main`
(`_copy_kernel` and `copy_g._k`), which measure the TPU's memory floor; their
grid sizes are only the TPU's block sizes.  On the H100 the kernel
(`csrc/copy.cu`) is bound by bytes and nothing else: 16-byte loads and stores,
neighbouring threads on neighbouring addresses, four loads in flight per
thread, one grid that covers the tensor once.  Its time gives the card's
measured memory rate, beside the data sheet's 3.35 TB/s.  It takes bf16,
as the TPU kernels do, starting on a 16-byte boundary (a fresh allocation
does; a view that starts inside its storage may not).  Nothing on the
serving path calls it.
"""

from __future__ import annotations

import ctypes

import torch

from enhanced_unet_tpu_torch.ops.kernels import build
from enhanced_unet_tpu_torch.utils.profiler import track_launches

LAUNCHES = track_launches({"copy": 0})
_SOURCE = "copy"


def copy_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version: a new tensor equal to x."""
    return x.clone()


def _lib() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    if lib.copy_bytes.restype is not ctypes.c_int:
        lib.copy_bytes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_longlong, ctypes.c_void_p]
        lib.copy_bytes.restype = ctypes.c_int
    return lib


def copy(x: torch.Tensor) -> torch.Tensor:
    """A new tensor equal to x (bf16, contiguous, 16-byte aligned, any
    shape).  CPU tensor: the plain version.  CUDA tensor: the kernel.  What
    the kernel does not take raises on either device."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"copy takes bf16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("copy takes a contiguous tensor")
    if x.data_ptr() % 16:
        raise ValueError("copy takes a tensor that starts 16-byte aligned")
    if x.device.type == "cpu":
        return copy_plain(x)
    out = torch.empty_like(x)
    rc = _lib().copy_bytes(build.ptr(x), build.ptr(out),
                           x.numel() * x.element_size(),
                           build.stream_ptr(x.device))
    build.check(rc, "copy launch")
    LAUNCHES["copy"] += 1
    return out
