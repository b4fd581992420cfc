"""The serving pipeline's span readers (`portbench/spanread.py`): known
answers on a synthetic window and synthetic spans, None without spans or
with a root count that is not the requests', and a traced run of the cell
on the CPU at the checks' small size that prints the three metrics."""

import pytest

from portbench import harness, spanread
from portbench.tests.test_portbench_checks import CELL, CPU, SEED, small
from enhanced_unet_tpu_torch.utils import profiler

MS = 1_000_000        # ns


def _span(id_, name, start, end, device_ms, parent=None, root=None):
    return {"name": name, "id": id_, "parent": parent,
            "root": id_ if root is None else root, "start_ns": start * MS,
            "end_ns": end * MS, "device_ms": device_ms, "attrs": {}}


# two requests: the first with an upload, a preprocess and two forwards, the
# second with one forward; the device copies for 6 ms inside the upload, and
# its kernels leave 8 ms (the copy's 6 within it) over the upload, 10 ms
# inside the preprocess, 15 ms between the requests and 4 ms inside the
# second's forward (its innermost span)
SPANS = [_span(0, "serve.request", 0, 100, 100.0),
         _span(1, "serve.upload", 0, 9, 9.0, 0, 0),
         _span(2, "serve.preprocess", 10, 30, 20.0, 0, 0),
         _span(3, "model.forward", 30, 60, 30.0, 0, 0),
         _span(4, "model.forward", 60, 80, 20.0, 0, 0),
         _span(5, "serve.request", 120, 200, 80.0),
         _span(6, "model.forward", 130, 170, 40.0, 5, 5),
         _span(7, "model.unetpp.encoder", 131, 140, 9.0, 6, 5)]
KERNELS = [("Memcpy HtoD", 1 * MS, 7 * MS), ("clahe", 8 * MS, 15 * MS),
           ("conv", 25 * MS, 100 * MS), ("conv", 30 * MS, 60 * MS),
           ("conv", 115 * MS, 150 * MS), ("conv", 154 * MS, 200 * MS)]


def _view(requests=2):
    return harness.TraceView(0.2, KERNELS, {"requests": requests})


def test_known_answers():
    t = _view()
    assert spanread.pipeline_ms(t, SPANS) == pytest.approx(((100 - 50) + (80 - 40)) / 2)
    assert spanread.forward_ms(t, SPANS) == pytest.approx((50 + 40) / 2)
    assert spanread.idle_by_span(t.kernels, SPANS) == pytest.approx(
        {"serve.upload": 8.0, "serve.preprocess": 10.0, None: 15.0, "model.forward": 4.0})
    # the copy is no idle time: taken off the gaps inside spans
    assert spanread.program_idle_ms(t, SPANS) == pytest.approx((8 + 10 + 4 - 6) / 2)


def test_gaps_within_bounds():
    ops = [("a", 5, 10), ("b", 8, 12), ("c", 20, 30)]
    assert spanread.gaps(ops, 0, 40) == [(0, 5), (12, 20), (30, 40)]
    assert spanread.gaps(ops, 6, 25) == [(12, 20)]
    assert spanread.gaps([], 3, 7) == [(3, 7)]


@pytest.mark.parametrize("spans,requests", [([], 2), (SPANS, 3), (SPANS[:5], 2)])
def test_no_reading_without_one_root_a_request(spans, requests):
    t = _view(requests)
    for read in (spanread.pipeline_ms, spanread.forward_ms, spanread.program_idle_ms):
        assert read(t, spans) is None


def test_a_program_without_spans_gives_nothing(monkeypatch):
    monkeypatch.delattr(profiler, "spans")
    assert spanread.recorded() == []
    assert spanread.pipeline_ms(_view()) is None


def test_a_traced_run_prints_the_pipeline_metrics():
    profiler.clear()
    r = harness.run(CELL, SEED, 0.3, True, 0.0, device=CPU, adjust=small)
    metrics = r["metrics"]
    for name in ("pipeline_ms.tiled", "forward_ms.tiled", "program_idle_ms.tiled"):
        assert name in metrics and metrics[name]["unit"] == "ms", metrics
    roots = [s for s in profiler.spans() if s["parent"] is None]
    assert len(roots) == r["attempted"]
    # on the CPU the device's time is the host's: the stages and the
    # forwards share the request's
    whole = sum(s["device_ms"] for s in roots) / len(roots)
    pipeline, forward = metrics["pipeline_ms.tiled"]["value"], metrics["forward_ms.tiled"]["value"]
    assert 0 < pipeline < whole and 0 < forward < whole
    assert pipeline + forward == pytest.approx(whole)
    # no device operations: the spans' whole extent is one gap
    extent = (roots[-1]["end_ns"] - roots[0]["start_ns"]) / 1e6
    assert metrics["program_idle_ms.tiled"]["value"] == pytest.approx(extent / len(roots))

