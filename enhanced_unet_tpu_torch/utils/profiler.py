"""Step timing, profiler traces and debug toggles, ported from
`enhanced_unet_tpu/utils/profiler.py`.

- `StepTimer`: wall-clock step times with warm-up steps skipped, and
  items per second;
- `trace_context`: `torch.profiler` over CPU and CUDA activities around a
  block, written as a Chrome trace into a directory;
- `enable_debug`: autograd's anomaly detection.

A step time on the host clock covers the device's work only when the timed
block ends in `torch.cuda.synchronize()` (or a copy to the host).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import torch


class StepTimer:
    """Accumulates step wall times; skips `warmup` steps (first-call noise:
    kernel loads, cuDNN's algorithm search, the caching allocator)."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._times: List[float] = []
        self._seen = 0
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self._seen += 1
        if self._seen > self.warmup:
            self._times.append(dt)
        return dt

    @contextlib.contextmanager
    def step(self):
        self.start()
        yield
        self.stop()

    def summary(self, items_per_step: int = 1) -> Dict[str, float]:
        if not self._times:
            return {"steps": 0, "mean_sec": 0.0, "items_per_sec": 0.0}
        mean = sum(self._times) / len(self._times)
        return {
            "steps": len(self._times),
            "mean_sec": mean,
            "p50_sec": sorted(self._times)[len(self._times) // 2],
            "items_per_sec": items_per_step / mean if mean > 0 else 0.0,
        }


@contextlib.contextmanager
def trace_context(log_dir: Optional[str]):
    """Profile the block with `torch.profiler` (CPU, and CUDA when a card is
    present) and write `trace.json` (Chrome trace format) into `log_dir`;
    nothing when `log_dir` is empty.  Yields the profiler, or None."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def enable_debug(nans: bool = True, disable_jit: bool = False) -> None:
    """Debug toggles.  `nans` turns on autograd's anomaly detection, which
    raises where a backward pass produces NaN and names the forward op.
    `disable_jit` is taken for the JAX package's signature and changes
    nothing: the port compiles nothing (no `torch.compile`, no CUDA graphs),
    so every op already runs eagerly."""
    if nans:
        torch.autograd.set_detect_anomaly(True)
