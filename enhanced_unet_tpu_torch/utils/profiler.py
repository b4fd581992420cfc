"""Step timing, profiler traces, spans and debug toggles; the first three
ported from `enhanced_unet_tpu/utils/profiler.py`.

- `StepTimer`: wall-clock step times with warm-up steps skipped, and
  items per second;
- `trace_context`: `torch.profiler` over CPU and CUDA activities around a
  block, written as a Chrome trace into a directory, with the block's
  spans and counters beside it;
- `span`, `count`, `spans`, `counters`, `clear`: the program's spans and
  counters (`Recorder`), which record only while a torch profiler runs;
  `track_launches`: a kernel module's launch counts among the counters;
- `enable_debug`: autograd's anomaly detection.

A step time on the host clock covers the device's work only when the timed
block ends in `torch.cuda.synchronize()` (or a copy to the host).
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

import torch

_profiling = torch.autograd._profiler_enabled


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


class _NoSpan:
    """What `Recorder.span` returns while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None


NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("_rec", "name", "attrs", "device", "id", "parent", "root", "start_ns",
                 "end_ns", "_events", "_device_ms", "_token")

    def __init__(self, rec: "Recorder", name: str, device, attrs: Dict[str, Any]):
        self._rec, self.name, self.device, self.attrs = rec, name, device, attrs
        self.end_ns = self._events = self._device_ms = None

    def __enter__(self):
        rec = self._rec
        outer = rec._current.get()
        self.id = next(rec._ids)
        self.parent = None if outer is None else outer.id
        self.root = self.id if outer is None else outer.root
        if self.device is None and outer is not None:
            self.device = outer.device
        self._token = rec._current.set(self)
        rec._spans.append(self)
        if self.device is not None and torch.device(self.device).type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            self._events = (stream, torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
        self.start_ns = time.time_ns()
        if self._events:
            self._events[1].record(self._events[0])
        return self

    def __exit__(self, *exc) -> None:
        if self._events:
            self._events[2].record(self._events[0])
        self.end_ns = time.time_ns()
        self._rec._current.reset(self._token)

    def record(self) -> Dict[str, Any]:
        if self._device_ms is None and self.end_ns is not None:
            if self._events:
                _, begin, end = self._events
                end.synchronize()
                self._device_ms = begin.elapsed_time(end)
                self._events = None
            else:
                self._device_ms = (self.end_ns - self.start_ns) / 1e6
        return {"name": self.name, "id": self.id, "parent": self.parent, "root": self.root,
                "start_ns": self.start_ns, "end_ns": self.end_ns,
                "device_ms": self._device_ms, "attrs": self.attrs}


class Recorder:
    """Spans and counters of the program, recorded only while a torch
    profiler runs (`torch.autograd._profiler_enabled()`: `trace_context`, or
    any `torch.profiler.profile`); otherwise `span` returns `NO_SPAN` and
    `count` adds nothing.

    A span records its name, attributes, id, its parent's id (the span open
    around it in this thread or task) and its root's (the outermost), and
    its host start and end from `time.time_ns()`: Unix nanoseconds, the
    clock of the profiler's events (Kineto's), so a span lies over a trace's
    host and device events without a correlation id.  A span's device is
    the one its work runs on: given to `span`, else its parent's.  On a
    CUDA device it also records a timing event on that device's current
    stream at entry and at exit: its `device_ms` runs from the moment the
    device finished the work queued before the span to the moment it
    finished the span's own, idle time inside the span included.  On the
    CPU, or with no device, the host's interval is the device's (the CPU
    runs the ops as they are called).  `device_ms` is resolved when
    `spans()` first reads a closed span, waiting for its end event.

    `counters()` also reports the launch counts of the kernel modules that
    registered theirs (`track_launches`), as `launches.<kernel>` since
    `clear()`: whether a request ran the hand-written kernels or fell back
    to their plain versions."""

    def __init__(self):
        self._current: contextvars.ContextVar = contextvars.ContextVar("span", default=None)
        self._ids = itertools.count()
        self._lock = threading.Lock()
        self._spans: List[_Span] = []
        self._counts: Dict[str, int] = {}
        self._launches: List[Dict[str, int]] = []
        self._launch_base: Dict[str, int] = {}

    def span(self, name: str, device=None, **attrs):
        """A context manager: the span `name` around the block, its work on
        `device` (None: the enclosing span's)."""
        return _Span(self, name, device, attrs) if _profiling() else NO_SPAN

    def count(self, name: str, n: int = 1) -> None:
        """Add `n` to the counter `name`."""
        if _profiling():
            with self._lock:
                self._counts[name] = self._counts.get(name, 0) + n

    def track_launches(self, launches: Dict[str, int]) -> Dict[str, int]:
        """Report a kernel module's launch counts (its `LAUNCHES`, which
        count whether or not a profiler runs) in `counters()`; returns
        them."""
        with self._lock:
            self._launches.append(launches)
            self._launch_base.update((f"launches.{k}", v) for k, v in launches.items())
        return launches

    def _launch_counts(self) -> Dict[str, int]:
        return {f"launches.{k}": v for d in self._launches for k, v in d.items()}

    def spans(self) -> List[Dict[str, Any]]:
        """The spans recorded since `clear()`, in the order they opened (an
        open span has `end_ns` and `device_ms` None)."""
        return [s.record() for s in list(self._spans)]

    def counters(self) -> Dict[str, int]:
        """The counters since `clear()`, and the tracked launch counts since
        then as `launches.<kernel>`."""
        with self._lock:
            out = dict(self._counts)
            out.update((k, v - self._launch_base.get(k, 0))
                       for k, v in self._launch_counts().items())
        return out

    def clear(self) -> None:
        """Forget every span and counter recorded so far."""
        with self._lock:
            self._spans = []
            self._counts = {}
            self._launch_base = self._launch_counts()


RECORDER = Recorder()
span, count, spans, counters, clear, track_launches = (
    RECORDER.span, RECORDER.count, RECORDER.spans, RECORDER.counters, RECORDER.clear,
    RECORDER.track_launches)


@contextlib.contextmanager
def trace_context(log_dir: Optional[str]):
    """Profile the block with `torch.profiler` (CPU, and CUDA when a card is
    present) and write `trace.json` (Chrome trace format) into `log_dir`,
    and `spans.json` beside it: the block's spans and counters (`clear()`
    at its start), host times in Unix nanoseconds; nothing when `log_dir`
    is empty.  Yields the profiler, or None."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    clear()
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump({"clock": "unix_ns", "spans": spans(), "counters": counters()}, f)


def enable_debug(nans: bool = True, disable_jit: bool = False) -> None:
    """Debug toggles.  `nans` turns on autograd's anomaly detection, which
    raises where a backward pass produces NaN and names the forward op.
    `disable_jit` is taken for the JAX package's signature and changes
    nothing: the port compiles nothing (no `torch.compile`, no CUDA graphs),
    so every op already runs eagerly."""
    if nans:
        torch.autograd.set_detect_anomaly(True)
