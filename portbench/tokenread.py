"""What the token model's per-layer metrics read from a traced window
(`harness.TraceView`), beside `traceread.py` and `spanread.py`: each
metric's file under `metrics/` names one of these.  Each gives None where
the window recorded nothing for it (a program without the model, its
kernel or its spans)."""

from __future__ import annotations

from portbench import spanread
from portbench.counts.tokens import attention_bound_s, dw_gelu_bound_s

DW_GELU_KERNEL = "dw3x3_gelu_nhwc_kernel"
# the kernels `F.scaled_dot_product_attention` launches for the model's
# bf16 calls (head size 64): on the H100 with torch 2.11 cuDNN's
# `cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_knob_7_64x128x64_
# 4x1x1_cga1x1x1_kernel0_0`, the only one its traces show; where another
# backend is chosen, FlashAttention-2's `pytorch_flash::flash_fwd_kernel`
# (and `flash_fwd_splitkv_kernel`) or the memory-efficient `fmha_cutlassF_*`
SDPA_KERNELS = ("flash_fwd", "fmha_cutlass", "native_sdpa")
HEAD = "model.segformer.head"


def _roofline(calls, bound, busy):
    return 100.0 * sum(bound(*c) for c in calls) / busy if calls and busy > 0 else None


def dw_gelu_roofline(t):
    """The least time of the recorded Mix-FFN depthwise calls
    (`counts/tokens.py`) over the device time of the kernels named
    `dw3x3_gelu_nhwc_kernel`, in %."""
    return _roofline(t.counts.get("dw_gelu_calls"), dw_gelu_bound_s,
                     t.kernel_seconds(lambda name: DW_GELU_KERNEL in name))


def attention_roofline(t):
    """The least time of the recorded attention calls over the device time
    of the kernels whose names hold one of `SDPA_KERNELS`, in %."""
    return _roofline(t.counts.get("attention_calls"), attention_bound_s,
                     t.kernel_seconds(lambda name: any(k in name for k in SDPA_KERNELS)))


def head_ms(t, spans=None):
    """The `model.segformer.head` spans' `device_ms` a request, over the
    window's requests (`spanread.requests`)."""
    spans = spanread.recorded() if spans is None else spans
    got = spanread.requests(t, spans)
    if got is None:
        return None
    roots = {r["id"] for r in got[0]}
    heads = [s["device_ms"] for s in spans if s["name"] == HEAD and s["root"] in roots]
    return sum(heads) / len(roots) if heads else None
