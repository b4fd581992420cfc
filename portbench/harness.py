"""The benchmark's machinery, driven by `BENCHMARK.json` and by files found
by name:

- `portbench/configs/<config>.json`: a model configuration (the program's
  model name, kwargs and dtype; the weights' gains);
- `portbench/traffic/<traffic>.json`: a traffic mix, whose `kind` names the
  code that serves it, `portbench/kinds/<kind>.py`;
- `portbench/reference/<config>.py`: the configuration's plain reference;
- `portbench/metrics/<metric>.py`: the reader of a per-layer metric;
- `portbench/limits/<workload>.json`: the limits of the cell's comparison.

One run: set-up (the program's model, the benchmark's weights and inputs,
one warm-up request or step), a measured window of `--seconds`, with the
profiler on for `--trace 1`, then the comparison with the reference, and one
JSON line on standard output.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "enhanced_unet_tpu"})
CACHE = HERE / ".cache"
WINDOW = "portbench.window"     # the host span around the measured window


class RunError(Exception):
    """A run that cannot give a result: exit code 2, nothing printed."""


def cache_environment() -> None:
    """Every compiler and kernel cache in fixed directories of the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)


def forbidden_modules(names) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of `FORBIDDEN`, compared as whole names."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


# ---------------------------------------------------------------------------
# finding things by name
# ---------------------------------------------------------------------------

def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise RunError(f"{path} not found")
    return load_json(path)


def module_at(path: Path, name: str):
    """Import the Python file `path` under the module name `name`."""
    if not path.is_file():
        raise RunError(f"{path} not found")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """Everything one workload of the manifest names, found by name."""

    def __init__(self, bench: dict, workload: str, base: Path = HERE):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise RunError(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = cells[workload]
        self.name = workload
        self.config_name = self.workload["config"]
        self.config = load_json(base / "configs" / f"{self.config_name}.json")
        self.traffic = load_json(base / "traffic" / f"{self.workload['traffic']}.json")
        self.kind = self.traffic["kind"]
        self.base = base
        self.end_to_end = [m for m in bench["end_to_end"] if applies(m, workload)]
        self.per_layer = [m for m in bench["per_layer"] if applies(m, workload)]
        limits = base / "limits" / f"{workload}.json"
        self.limits = load_json(limits) if limits.is_file() else {}
        self._modules: Dict[str, Any] = {}

    def kind_module(self):
        return module_at(self.base / "kinds" / f"{self.kind}.py",
                         f"portbench_kind_{self.kind}")

    def reference(self):
        name = self.config_name
        mod = self._modules.get(name)
        if mod is None:
            mod = self._modules[name] = module_at(self.base / "reference" / f"{name}.py",
                                                  f"portbench_reference_{name}")
        return mod

    def metric_reader(self, name: str) -> Callable:
        return module_at(self.base / "metrics" / f"{name}.py", f"portbench_metric_{name}").read


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


# ---------------------------------------------------------------------------
# the device
# ---------------------------------------------------------------------------

def require_cards(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise RunError("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell needs {chips} cards, {torch.cuda.device_count()} present")


def card_info() -> Dict[str, Any]:
    """Name, power limit and clocks of card 0, from `nvidia-smi`."""
    fields = ("name", "power.limit", "clocks.sm", "clocks.max.sm", "clocks.mem")
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={','.join(fields)}",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return {"nvidia_smi": f"unavailable: {e}"}
    values = [v.strip() for v in out.stdout.strip().splitlines()[0].split(",")]
    info = dict(zip(("smi_name", "power_limit_w", "clock_sm_mhz", "clock_sm_max_mhz",
                     "clock_mem_mhz"), values))
    for k in list(info)[1:]:
        try:
            info[k] = float(info[k])
        except ValueError:
            pass
    return info


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------

class TraceView:
    """What a per-layer metric's reader reads: the traced window's device
    operations and the work the kind's code and the wrappers counted in it."""

    def __init__(self, window_s: float, ops: list, counts: dict):
        self.window_s = window_s
        self.kernels = [o for o in ops if not o[0].startswith(("Memcpy", "Memset"))]
        self.counts = counts              # requests, pixels, images, flops, k1, k2, ...
        self.busy_s = union_seconds(ops)

    def kernel_seconds(self, match: Callable[[str], bool]) -> float:
        return sum(e - s for n, s, e in self.kernels if match(n)) / 1e9


def union_seconds(ops) -> float:
    total, end = 0, None
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e9


def kineto_events(prof):
    """(device ops, host ops) of a finished profiler, as (name, start_ns,
    end_ns), read from the Kineto results without building FunctionEvents."""
    import torch

    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns() if hasattr(ev, "start_ns") else ev.start_us() * 1000
        dur = ev.duration_ns() if hasattr(ev, "duration_ns") else ev.duration_us() * 1000
        item = (ev.name(), start, start + dur)
        if ev.device_type() != torch.autograd.DeviceType.CUDA:
            host.append(item)
        elif item[0] != WINDOW:       # the window's own span, mirrored on the device
            device.append(item)
    return device, host


def breakdown(device_ops, host_ops, t0_ns: int, t1_ns: int) -> dict:
    """The device operations that took most time, and the idle gaps of the
    device by the innermost host operation running at each gap's middle."""
    by_name: Dict[str, float] = {}
    for n, s, e in device_ops:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e9
    gaps = []
    end = t0_ns
    for _, s, e in sorted(device_ops, key=lambda o: o[1]):
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if t1_ns > end:
        gaps.append((end, t1_ns))
    host = sorted((h for h in host_ops if h[0] != WINDOW), key=lambda o: o[1])
    starts = [h[1] for h in host]
    by_host: Dict[str, float] = {}
    for s, e in gaps:
        mid = (s + e) // 2
        i = bisect.bisect_right(starts, mid) - 1
        label = "host between operations"
        # the latest-starting host op that still covers the middle (among
        # the 400 before it: an enclosing op starts that close in practice)
        for j in range(i, max(i - 400, -1), -1):
            if host[j][2] >= mid:
                label = host[j][0]
                break
        by_host[label] = by_host.get(label, 0.0) + (e - s) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:200], v] for n, v in top],
            "idle_gaps": [[n[:200], v] for n, v in idle]}


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def phase(phases: Dict[str, float], name: str):
    """Add the seconds of the `with` body to `phases[name]`."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        phases[name] = phases.get(name, 0.0) + time.perf_counter() - t0


def quantile(values: List[float], q: float) -> float:
    """The q-quantile by linear interpolation between order statistics."""
    v = sorted(values)
    pos = (len(v) - 1) * q
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def window_profile(window: dict) -> dict:
    """Host-clock latencies of the window's calls (ms quantiles) and the
    calls finished in each tenth of it: how steady the window ran."""
    lat = window["latencies"]
    if not lat:
        return {}
    ends, t, tenths = [], 0.0, [0] * 10
    for x in lat:
        t += x
        ends.append(t)
    for e in ends:
        tenths[min(int(10 * e / max(ends[-1], 1e-9)), 9)] += 1
    return {"ms": {f"p{q}": quantile(lat, q / 100) * 1e3 for q in (5, 50, 95, 100)},
            "calls_by_tenth": tenths}


def measure(work, seconds: float, sync: Callable[[], None]) -> dict:
    """Call `work.step(i)` for i = 0, 1, ... while the window is open, each
    call timed on the host; the window closes when the last call's work is
    done on the device."""
    latencies = []
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        ts = time.perf_counter()
        work.step(i)
        latencies.append(time.perf_counter() - ts)
        i += 1
    sync()
    return {"steps": i, "latencies": latencies, "window_s": time.perf_counter() - t0}


def run(workload: str, seed: int, seconds: float, trace: bool, t_start: float,
        root: Path = ROOT, device=None, adjust: Optional[Callable[[Cell], None]] = None
        ) -> dict:
    """One run of `workload`; returns the result line's object (`checks`
    last).  `device` None: the cell's cards, which must be there (tests pass
    the CPU); `adjust(cell)` may change the cell's files as read (tests)."""
    bench = manifest(root)
    cell = Cell(bench, workload, root / "portbench")
    if adjust is not None:
        adjust(cell)
    import torch

    if device is None:
        require_cards(int(cell.workload["chips"]))
        device = torch.device("cuda")
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    work = cell.kind_module().Workload(cell, seed, device)
    before = time.perf_counter() - t_start       # interpreter, imports, the card's context
    work.setup()
    sync()
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        wrappers = work.install_counters()
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                with record_function(WINDOW):
                    window = measure(work, seconds, sync)
        finally:
            wrappers.remove()
    else:
        window = measure(work, seconds, sync)
    window_peak = torch.cuda.max_memory_allocated() if on_card else 0

    metrics: Dict[str, dict] = {}
    device_info = {"platform": "gpu" if on_card else device.type,
                   "kind": torch.cuda.get_device_name(device) if on_card else device.type,
                   "count": int(cell.workload["chips"]),
                   "memory_peak_bytes": max(window_peak, setup_peak),
                   **(card_info() if on_card else {})}
    extra: Dict[str, Any] = {}
    if trace:
        t_read = time.perf_counter()
        device_ops, host_ops = kineto_events(prof)
        del prof
        _, t0_ns, t1_ns = next(h for h in host_ops if h[0] == WINDOW)
        ops = [(n, max(s, t0_ns), min(e, t1_ns)) for n, s, e in device_ops
               if e > t0_ns and s < t1_ns]
        counts = dict(work.window_counts(window), peak_bytes=window_peak, **wrappers.counts())
        view = TraceView((t1_ns - t0_ns) / 1e9, ops, counts)
        device_info.update(busy_s=view.busy_s, window_s=view.window_s)
        for m in cell.per_layer:
            value = cell.metric_reader(m["name"])(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra["breakdown"] = breakdown(ops, host_ops, t0_ns, t1_ns)
        extra["trace_read_s"] = time.perf_counter() - t_read
        del device_ops, host_ops, ops
    else:
        e2e = work.end_to_end(window)
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            if m["name"] not in e2e:
                raise RunError(f"the {cell.kind} kind gives no {m['name']}")
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    checks = work.check(window)            # frees the program's state first
    correct = all(c["limit"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())
    return {"correct": correct, "attempted": window["steps"], "failed": 0,
            "metrics": metrics, "device": device_info, **extra,
            "setup_s": setup_s, "setup_phases": {"before_setup": before, **work.phases},
            "window_s": window["window_s"], "window_profile": window_profile(window),
            "check_details": getattr(work, "details", {}),
            "checks": checks}


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        result = run(args.workload, args.seed, args.seconds, bool(args.trace), t_start)
    except RunError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules(sys.modules)
    if found:
        print(f"portbench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
