"""Frozen work arithmetic of the hand-written kernels and the card's peaks.

The least time a call can take on one H100 SXM is the larger of its
operations over the peak rate and its bytes over the HBM bandwidth, with
each input byte read once and each output byte written once.  K2 is the
fused 3x3 conv + BN + ReLU (`csrc/conv3x3_bn_act.cu`), K1 the two passes of
the fused MBConv (`csrc/mbconv*.cu`); the formulas are those the kernels'
bring-up used on the card.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12             # H100 SXM HBM3
PEAK_OPS = {"bf16": 989e12, "fp32": 67e12}   # dense tensor-core bf16; fp32 on CUDA cores
PEAK_BF16 = PEAK_OPS["bf16"]


def bound_s(bytes_moved: float, ops: float, kind: str) -> float:
    return max(bytes_moved / HBM_BYTES_PER_S, ops / PEAK_OPS[kind])


def _kind(element_size: int) -> str:
    return "bf16" if element_size == 2 else "fp32"


def k2_bound_s(n: int, h: int, w: int, cin: int, cout: int, element_size: int = 2) -> float:
    """K2 on [n, h, w, cin] -> cout: x read and the output written once, the
    weights once in the input's dtype, the fp32 scale and shift once;
    2 * 9 * Cin * Cout operations per output pixel."""
    es = element_size
    return bound_s(n * h * w * (cin + cout) * es + 9 * cin * cout * es + cout * 8,
                   2 * 9 * cin * cout * n * h * w, _kind(es))


def k1_pass_bound_s(which: int, n: int, cin: int, h: int, w: int, mid: int, cout: int,
                    expand: bool, element_size: int = 2) -> float:
    """One pass of K1 on [n, cin, h, w] with `mid` depthwise channels.  Per
    pixel the expand (2 * cin * mid, bias and SiLU ~5 * mid) where there is
    one, the depthwise with bias and SiLU (23 * mid); pass 1 adds the pool's
    sum (mid) and writes [n, mid] fp32 sums; pass 2 adds the gated
    projection (2 * mid * cout) with bias and residual (2 * cout), reads
    the [n, mid, cout] gated weights and writes the output."""
    es, e = element_size, int(expand)
    hw = n * h * w
    ops = (2 * cin + 5) * mid * e + 23 * mid
    w_bytes = (mid * cin * es + mid * 4) * e + mid * (9 * es + 4)
    if which == 1:
        return bound_s(hw * cin * es + w_bytes + n * mid * 4, hw * (ops + mid), _kind(es))
    return bound_s(hw * (cin + cout) * es + w_bytes + n * mid * cout * es + cout * 4,
                   hw * (ops + 2 * mid * cout + 2 * cout), _kind(es))
