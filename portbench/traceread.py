"""What the per-layer metrics read from a traced window (`harness.TraceView`):
each metric's file under `metrics/` names one of these."""

from __future__ import annotations

from portbench.counts.kernels import PEAK_BF16, k1_pass_bound_s, k2_bound_s


def mfu(t):
    """Model FLOPs of the window's forwards, counted on the reference, over
    its seconds and the dense bf16 peak, in %."""
    flops = t.counts.get("flops")
    return 100.0 * flops / t.window_s / PEAK_BF16 if flops else None


def k2_roofline(t):
    """The least time of the K2 calls the kernel layer's launch function
    recorded over the device time of the kernels named `conv3x3_bn_act*`,
    in %: work and time of the same calls."""
    calls = t.counts.get("k2_calls")
    busy = t.kernel_seconds(lambda name: "conv3x3_bn_act" in name)
    return 100.0 * sum(k2_bound_s(*c) for c in calls) / busy if calls and busy > 0 else None


def k1_roofline(t):
    """The least time of the recorded fused MBConv passes over the device
    time of the kernels whose names hold `mbconv`, in %."""
    calls = t.counts.get("k1_calls")
    busy = t.kernel_seconds(lambda name: "mbconv" in name)
    return 100.0 * sum(k1_pass_bound_s(*c) for c in calls) / busy if calls and busy > 0 else None


def device_idle(t):
    """1 - the union of the device operations' intervals over the window,
    in %."""
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t.window_s > 0 else None


def peak_mem_gib(t):
    """`torch.cuda.max_memory_allocated` over the window (reset at its
    start), GiB."""
    peak = t.counts.get("peak_bytes")
    return peak / 2 ** 30 if peak else None
