"""The port's spans and counters (`utils/profiler.py` `Recorder`) and where
the serving path records them: off without a profiler; under one, a tiled
request of the tiny flagship gives one root, its seven stages in order and
a `model.forward` a forward size, each with the model's five branches,
every span inside its parent; a span holds the profiler's own events of
the ops run inside it (one clock); the pack and fold counters read 0 on a
repeated request and every cached pack and fold after `update_state`;
`trace_context` writes them beside its trace."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from enhanced_unet_tpu_torch.models import get_model
from enhanced_unet_tpu_torch.ops.kernels import conv_fused
from enhanced_unet_tpu_torch.ops.tiling import tile_grid
from enhanced_unet_tpu_torch.train.evaluator import Evaluator
from enhanced_unet_tpu_torch.utils import profiler, trace_context

torch.set_num_threads(1)
TINY = ("efficientnet-tiny", "efficientnet-tiny")
H, W, TILE, OVERLAP = 96, 128, 64, 16
STAGES = ["serve.upload", "serve.preprocess", "serve.tiles", "serve.tta", "serve.stitch",
          "serve.cascade", "serve.download"]
BRANCHES = ["model.unetpp.encoder", "model.unetpp.decoder", "model.deeplab.encoder",
            "model.deeplab.decoder", "model.fusion"]


def profiled(fn):
    profiler.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, profiler.spans(), profiler.counters(), prof


@pytest.fixture(scope="module")
def model():
    return get_model("enhanced_unet", dtype=torch.float32, device="cpu", seed=3,
                     encoder_names=TINY)


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(5).random((1, H, W, 3)).astype(np.float32)


def evaluator(model, tta):
    return Evaluator(model, "enhanced_unet", enable_tta=tta, device="cpu", verbose=False,
                     tiled=True, tile=TILE, overlap=OVERLAP)


def test_nothing_records_without_a_profiler():
    rec = profiler.Recorder()
    with rec.span("a", x=1) as s:
        rec.count("c", 2)
    assert s is profiler.NO_SPAN and rec.span("b") is profiler.NO_SPAN
    assert rec.spans() == [] and not any(rec.counters().values())


def test_a_recorder_nests_and_clears():
    rec = profiler.Recorder()
    with profile(activities=[ProfilerActivity.CPU]):
        with rec.span("outer", k="v"):
            with rec.span("inner"):
                rec.count("c")
                rec.count("c", 2)
        with rec.span("next"):
            pass
    outer, inner, nxt = rec.spans()
    assert [s["name"] for s in (outer, inner, nxt)] == ["outer", "inner", "next"]
    assert outer["attrs"] == {"k": "v"} and outer["parent"] is None
    assert inner["parent"] == inner["root"] == outer["id"] == outer["root"]
    assert nxt["parent"] is None and nxt["root"] == nxt["id"] != outer["id"]
    # without CUDA the device's time is the host's
    assert outer["device_ms"] == (outer["end_ns"] - outer["start_ns"]) / 1e6
    assert rec.counters()["c"] == 3
    rec.clear()
    assert rec.spans() == [] and "c" not in rec.counters()


@pytest.mark.parametrize("tta", [True, False])
def test_a_tiled_request_records_its_stages_and_forwards(model, image, tta):
    ev = evaluator(model, tta)
    ev.predict_semantic_masks_tiled(image)            # packs and folds once
    masks, spans, counters, _ = profiled(lambda: ev.predict_semantic_masks_tiled(image))
    assert masks.shape == (1, H, W)
    by_id = {s["id"]: s for s in spans}
    roots = [s for s in spans if s["parent"] is None]
    assert len(roots) == 1 and roots[0]["name"] == "serve.request"
    assert roots[0]["attrs"] == {"images": 1, "height": H, "width": W, "tiled": True}
    root = roots[0]["id"]
    assert [s["name"] for s in spans if s["parent"] == root] == STAGES
    forwards = [s for s in spans if s["name"] == "model.forward"]
    tiles = len(tile_grid(H, W, TILE, OVERLAP)[2])
    want = ([(3 * tiles, 64, 64), (tiles, 64, 64), (tiles, 96, 96)] if tta
            else [(tiles, 64, 64)])
    assert [(f["attrs"]["n"], f["attrs"]["h"], f["attrs"]["w"]) for f in forwards] == want
    tta_span = next(s for s in spans if s["name"] == "serve.tta")
    for f in forwards:
        assert f["parent"] == tta_span["id"]
        assert [s["name"] for s in spans if s["parent"] == f["id"]] == BRANCHES
    for s in spans:
        assert s["root"] == root and s["end_ns"] >= s["start_ns"]
        if s["parent"] is not None:
            p = by_id[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] and s["end_ns"] <= p["end_ns"], s
    assert counters.get("kernels.k2_pack", 0) == counters.get("kernels.k1_fold", 0) == 0


def test_a_span_holds_the_profilers_events_of_its_ops():
    x = torch.randn(128, 128)
    rec = profiler.Recorder()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.span("mm"):
            torch.mm(x, x)
    (s,) = rec.spans()
    mms = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert len(mms) == 1
    start = mms[0].start_ns()
    assert s["start_ns"] <= start <= start + mms[0].duration_ns() <= s["end_ns"]


def cached(model):
    packs = sum("_packed_conv3x3" in m.__dict__ for m in model.modules())
    folds = sum("_folded" in m.__dict__ for m in model.modules())
    return packs, folds


@pytest.mark.parametrize("swap", ["state_dict", "none"])
def test_pack_and_fold_counters(image, swap):
    model = get_model("enhanced_unet", dtype=torch.float32, device="cpu", seed=4,
                      encoder_names=TINY)
    ev = evaluator(model, False)
    ev.predict_semantic_masks_tiled(image)
    packs, folds = cached(model)
    assert packs > 0 and folds > 0
    if swap == "state_dict":
        ev.update_state({k: v + 0.01 if v.is_floating_point() else v
                         for k, v in model.state_dict().items()})
    _, _, counters, _ = profiled(lambda: ev.predict_semantic_masks_tiled(image))
    got = counters.get("kernels.k2_pack", 0), counters.get("kernels.k1_fold", 0)
    assert got == ((packs, folds) if swap == "state_dict" else (0, 0))


@pytest.mark.parametrize("recorder", ["own", "global"])
def test_counters_read_the_kernels_launch_counts(monkeypatch, recorder):
    # a recorder reports what was tracked with it; the kernel modules track
    # theirs with the program's
    if recorder == "own":
        rec = profiler.Recorder()
        launches, key = rec.track_launches({"k": 0, "j": 5}), "k"
    else:
        rec, launches, key = profiler.RECORDER, conv_fused.LAUNCHES, "conv3x3_bn_act_wgmma"
    rec.clear()
    monkeypatch.setitem(launches, key, launches[key] + 3)
    assert rec.counters()[f"launches.{key}"] == 3
    rec.clear()
    assert rec.counters()[f"launches.{key}"] == 0


def test_trace_context_writes_spans_beside_the_trace(tmp_path):
    with profiler.RECORDER.span("before"):           # no profiler: not recorded
        pass
    with trace_context(str(tmp_path)):
        with profiler.span("block", k=1):
            torch.ones(8).sum()
        profiler.count("c")
    with open(tmp_path / "spans.json") as f:
        got = json.load(f)
    assert got["clock"] == "unix_ns" and got["counters"]["c"] == 1
    assert [s["name"] for s in got["spans"]] == ["block"]
    assert (tmp_path / "trace.json").is_file()
