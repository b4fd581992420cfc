"""Frozen work arithmetic of the token model's kernels (SegFormer), beside
`counts/kernels.py`'s: each call's least time on one H100 SXM, the larger
of its operations over the peak rate and its bytes over the HBM bandwidth,
each input byte read once and each output byte written once.
"""

from __future__ import annotations

from portbench.counts.kernels import bound_s

# the epilogue's operations an element: the shift, and GELU's
# 0.5 * v * (1 + erf(v / sqrt 2)) with the erf counted once
GELU_EPILOGUE_OPS = 6


def dw_gelu_bound_s(n: int, h: int, w: int, c: int, element_size: int = 2) -> float:
    """The Mix-FFN's depthwise 3x3 + bias + GELU on [n, h, w, c]: x read
    and the output written once, the [3, 3, c] weights in x's dtype and the
    fp32 shift once; 2 * 9 multiply-adds and the epilogue an element, on the
    CUDA cores (the fp32 peak)."""
    pixels = n * h * w
    return bound_s(2 * pixels * c * element_size + 9 * c * element_size + 4 * c,
                   pixels * c * (2 * 9 + GELU_EPILOGUE_OPS), "fp32")


def attention_bound_s(n: int, heads: int, lq: int, lk: int, d: int,
                      element_size: int = 2) -> float:
    """softmax(q k^T / sqrt d) v: q, k and v read and the output written
    once; 4 * n * heads * Lq * Lk * d operations on the tensor cores (the
    bf16 peak; fp32 calls at the fp32 peak)."""
    moved = n * heads * (2 * lq + 2 * lk) * d * element_size
    return bound_s(moved, 4 * n * heads * lq * lk * d, "bf16" if element_size == 2 else "fp32")
