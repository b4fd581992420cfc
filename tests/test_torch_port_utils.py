"""The port's profiler utilities against the JAX package's
(`utils/profiler.py`): `StepTimer` gives the same summaries for the same
clock readings; `trace_context` writes a Chrome trace of a block on the
CPU and does nothing without a directory; `enable_debug` turns on
autograd's anomaly detection."""

import json
import os

import pytest
import torch

from enhanced_unet_tpu.utils import profiler as jprofiler
from enhanced_unet_tpu_torch.utils import StepTimer, enable_debug, trace_context

torch.set_num_threads(1)


def _clock(monkeypatch, readings):
    it = iter(readings)
    monkeypatch.setattr("time.perf_counter", lambda: next(it))


# (warmup, step durations): none past the warm-up, one, an odd and an even count
@pytest.mark.parametrize("warmup,durations", [
    (2, [0.5, 0.25]),
    (2, [0.5, 0.25, 0.125]),
    (1, [0.5, 0.3, 0.1, 0.2]),
    (0, [0.4, 0.1, 0.3, 0.2, 0.7]),
])
def test_step_timer_summary_equals_jax(monkeypatch, warmup, durations):
    readings = []
    t = 10.0
    for d in durations:
        readings += [t, t + d]
        t += d + 1.0
    summaries = []
    for cls in (StepTimer, jprofiler.StepTimer):
        _clock(monkeypatch, readings)
        timer = cls(warmup=warmup)
        seen = []
        for i in range(len(durations)):
            if i % 2:
                with timer.step():
                    pass
            else:
                timer.start()
                seen.append(timer.stop())
        summaries.append((timer.summary(items_per_step=4), seen))
    assert summaries[0] == summaries[1]
    assert summaries[0][0]["steps"] == max(len(durations) - warmup, 0)


def test_trace_context_writes_a_trace_on_the_cpu(tmp_path):
    log_dir = tmp_path / "trace"
    x = torch.randn(64, 64)
    with trace_context(str(log_dir)) as prof:
        y = (x @ x).relu().sum()
    assert prof is not None and torch.isfinite(y)
    with open(log_dir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


@pytest.mark.parametrize("log_dir", [None, ""])
def test_trace_context_without_a_directory_does_nothing(tmp_path, monkeypatch, log_dir):
    monkeypatch.chdir(tmp_path)
    with trace_context(log_dir) as prof:
        torch.ones(3).sum()
    assert prof is None and os.listdir(tmp_path) == []


def test_enable_debug_turns_on_anomaly_detection():
    assert not torch.is_anomaly_enabled()
    try:
        enable_debug(nans=False, disable_jit=True)
        assert not torch.is_anomaly_enabled()
        enable_debug()
        assert torch.is_anomaly_enabled()
        x = torch.tensor([0.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"), pytest.warns(UserWarning):
            (x / x).sum().backward()
    finally:
        torch.autograd.set_detect_anomaly(False)
