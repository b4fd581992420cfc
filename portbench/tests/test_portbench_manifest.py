"""BENCHMARK.json against the benchmark's contract, every cell's files
found by name, a cell added by files alone, the frozen work arithmetic and
the no-JAX check."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from portbench import harness
from portbench.counts import kernels

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ONE_LINE = re.compile(r"^[^\t\n\r]{1,200}$")
BENCH = harness.manifest()


def test_manifest_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and ONE_LINE.match(c["why"]) and ONE_LINE.match(c["source"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert ONE_LINE.match(w["why"])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert ONE_LINE.match(m["layer"]) and m["moves"] in e2e
        for w in m.get("workloads", cells):
            assert w in cells and harness.applies(e2e[m["moves"]], w)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files_by_name(workload):
    cell = harness.Cell(BENCH, workload)
    assert cell.config["name"] == cell.config_name
    assert hasattr(cell.kind_module(), "Workload")
    assert hasattr(cell.reference(), "build")
    for m in cell.per_layer:
        assert callable(cell.metric_reader(m["name"]))
    assert set(cell.limits) == {"logprob_gap", "mask_mismatch"}
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer


def test_a_cell_added_by_files_alone(tmp_path):
    """A new traffic mix, its limits and its cell: data files and manifest
    entries in a copy of the benchmark, no file edited; the copy's harness
    finds and serves it (on the CPU, at a small size)."""
    import torch

    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "eunet_serve_64", "config": "enhanced_unet_b5b4",
                               "traffic": "serve_64", "chips": 1, "why": "a test cell"})
    for name, unit in (("request_p95_ms", "ms"), ("serve_mpix_per_s", "Mpix/s")):
        bench["end_to_end"].insert(0, {"name": name, "unit": unit, "better": "lower",
                                       "bound": 0.25, "source": "host_clock",
                                       "workloads": ["eunet_serve_64"]})
    bench["per_layer"].append({"name": "device_idle.serve_64", "unit": "%", "better": "lower",
                               "source": "device_trace", "layer": "device",
                               "moves": "serve_mpix_per_s", "workloads": ["eunet_serve_64"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "portbench/metrics/device_idle.serve_64.py").write_text(
        "from portbench.traceread import device_idle as read  # noqa: F401\n")
    traffic = {"kind": "serve", "image_size": 64, "batch": 2, "pool": 4, "tta": True,
               "check_requests": 2}
    (root / "portbench/traffic/serve_64.json").write_text(json.dumps(traffic))
    shutil.copy(root / "portbench/limits/eunet_tiled_2048.json",
                root / "portbench/limits/eunet_serve_64.json")
    r = harness.run("eunet_serve_64", 2 ** 31 + 99, 0.5, False, 0.0, root=root,
                    device=torch.device("cpu"),
                    adjust=lambda cell: cell.config["calibration"].update(size=64))
    assert r["attempted"] >= 1 and set(r["metrics"]) == {"request_p95_ms", "serve_mpix_per_s",
                                                          "setup_s"}
    assert r["correct"], r["checks"]
    assert callable(harness.Cell(bench, "eunet_serve_64", root / "portbench")
                    .metric_reader("device_idle.serve_64"))


def test_k2_bound_at_the_tiled_trio():
    # [75, 512, 512, 256] -> 128 in bf16: operations bound, 11.7254 ms
    assert kernels.k2_bound_s(75, 512, 512, 256, 128) * 1e3 == pytest.approx(11.7254, abs=1e-4)
    # [6, 256, 256, 256] -> 32: bytes bound, 0.0677 ms
    assert kernels.k2_bound_s(6, 256, 256, 256, 32) * 1e3 == pytest.approx(0.0677, abs=1e-4)


def test_k1_bounds_at_a_serving_shape():
    # [6, 48, 256, 256] mid 48 -> 24, no expand: 0.0113 and 0.0169 ms, bytes
    assert kernels.k1_pass_bound_s(1, 6, 48, 256, 256, 48, 24, False) * 1e3 == pytest.approx(
        0.0113, abs=1e-4)
    assert kernels.k1_pass_bound_s(2, 6, 48, 256, 256, 48, 24, False) * 1e3 == pytest.approx(
        0.0169, abs=1e-4)


def test_flagship_flops_at_512():
    from portbench.counts.flops import forward_flops

    cell = harness.Cell(BENCH, "eunet_tiled_2048")
    flops = forward_flops(lambda: cell.reference().build(cell.config), [(1, 512, 512)])
    # the JAX package's XLA cost analysis: 364.5 GF an image
    assert 300e9 < flops < 420e9
    assert forward_flops(lambda: cell.reference().build(cell.config),
                         [(3, 512, 512)]) == 3 * flops


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_modules(["enhanced_unet_tpu_torch.x", "torch", "jaxtyping"]) == []
    assert harness.forbidden_modules(["enhanced_unet_tpu.x", "jax.numpy", "flax", "optax.a",
                                      "jaxlib"]) == ["enhanced_unet_tpu.x", "flax", "jax.numpy",
                                                     "jaxlib", "optax.a"]


def test_a_run_without_the_program_or_the_card_prints_nothing(tmp_path):
    """In a directory with only BENCHMARK.json and portbench/, a run exits
    non-zero and prints no result."""
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "eunet_tiled_2048",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_the_harness_imports_no_jax():
    code = ("import sys; sys.path.insert(0, %r); import portbench.harness, portbench.calibrate; "
            "from portbench.reference import common; from portbench import harness; "
            "print(harness.forbidden_modules(sys.modules))" % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.stdout.strip() == "[]", out.stderr
