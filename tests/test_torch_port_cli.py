"""The port's CLI (`enhanced_unet_tpu_torch/cli.py`) against the JAX
package's (`enhanced_unet_tpu/cli.py`):

- `CSV_COLUMNS` and `ZERO_RESULTS` equal, and `write_results_csv`'s file
  byte for byte, a model with a missing key included;
- each mode: the entry points of both packages monkeypatched to recorders,
  the same argv hands each entry the same arguments (dtype mapped to
  torch's, the serving config compared field by field, the port's `device`
  aside), and both CLIs write the same `evaluation_results.{json,csv}`;
- `--mode manifest` prints what the JAX CLI prints;
- an unknown model is isolated (zeros, rc 0);
- `--mode eval` end to end: `unet_basic` on a synthetic 96^2 folder, fp32
  on the CPU (finite metrics, the aggregate files, the comparison
  figures' names: `_save_figure` records them instead of rendering, which
  costs tens of seconds), and again without matplotlib (the results, no
  figure, a warning: the card's machine has no matplotlib);
- `--distributed` at world size 1: gloo from `torchrun`'s environment
  variables, set by the test, one epoch of `unet_basic`, the process group
  there during the call and gone after it;
- `--num-devices 2` without `--distributed`: a model whose two spawned
  (gloo) ranks fail is isolated, and the next model trains on two ranks.
"""

import dataclasses
import functools
import json
import os
import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from synthdata import make_synthetic_dataset
from test_torch_port_spawn import JOIN

import enhanced_unet_tpu.viz as jviz
from enhanced_unet_tpu import cli as jcli
from enhanced_unet_tpu.train import api as japi
import enhanced_unet_tpu_torch.viz as viz
from enhanced_unet_tpu_torch import cli
from enhanced_unet_tpu_torch.parallel import data_parallel
from enhanced_unet_tpu_torch.train import api
from enhanced_unet_tpu_torch.viz.visualizer import Visualizer

torch.set_num_threads(1)
ENTRIES = ("train_model", "evaluate_model", "visualize_model", "predict_model")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cells")
    make_synthetic_dataset(str(d), n_images=7, size=96, seed=6)   # train 4, val 1, test 2
    return str(d)


def test_csv_columns_equal_jax():
    assert cli.CSV_COLUMNS == jcli.CSV_COLUMNS


def test_zero_results_equal_jax():
    assert cli.ZERO_RESULTS == jcli.ZERO_RESULTS


def test_write_results_csv_byte_equal_to_jax(tmp_path):
    results = {"unet": {**cli.ZERO_RESULTS, "sem_mean_iou": 0.5, "sem_background_iou": 0.25},
               "segnet": {"sem_mean_iou": 0.125}}            # keys missing: 0.0
    cli.write_results_csv(results, str(tmp_path / "port.csv"))
    jcli.write_results_csv(results, str(tmp_path / "jax.csv"))
    ours = (tmp_path / "port.csv").read_bytes()
    assert ours == (tmp_path / "jax.csv").read_bytes()
    assert ours.startswith("﻿模型,语义分割 mIoU".encode("utf-8"))


class _NoFigures:
    """A Visualizer that draws nothing."""

    def __init__(self, save_dir="results"):
        self.save_dir = save_dir

    def plot_comprehensive_comparison(self, results):
        pass

    def plot_model_comparison(self, results):
        pass


def _record(module, calls, monkeypatch):
    """Replace `module`'s entry points with recorders appending
    (name, kwargs) to `calls`."""
    def recorder(name):
        def call(model_name, **kwargs):
            calls.append((name, model_name, kwargs))
            if name == "train_model":
                return f"ck/{model_name}/best_model"
            if name == "evaluate_model":
                return {"sem_mean_iou": 0.5, "live_iou": 0.25, "bbox_mAP": 0.125}
            return {}
        return call

    for name in ENTRIES:
        monkeypatch.setattr(module, name, recorder(name))


def _comparable(calls, port):
    out = []
    for name, model_name, kwargs in calls:
        kwargs = dict(kwargs)
        if port:
            assert kwargs.pop("device") == torch.device("cpu")
        dtype = kwargs.pop("dtype")
        kwargs["dtype"] = {torch.bfloat16: "bf16", torch.float32: "f32",
                           jnp.bfloat16: "bf16", jnp.float32: "f32"}[dtype]
        if kwargs.get("cfg") is not None:
            kwargs["cfg"] = dataclasses.asdict(kwargs["cfg"])
        out.append((name, model_name, kwargs))
    return out


ARGVS = {
    "train": ["--mode", "train", "--models", "unet", "enhanced_unet", "--epochs", "3",
              "--num-devices", "2", "--pretrained-dir", "weights", "--dtype", "float32",
              "--max-size", "320", "--data-dir", "cells", "--checkpoint-dir", "ck"],
    "eval": ["--mode", "eval", "--models", "fcn", "--tiled", "--tile", "256", "--overlap",
             "32", "--eval-batch", "4", "--serving-preset", "optimized"],
    "eval_exact": ["--mode", "eval", "--models", "enhanced_unet", "linknet"],
    "train_eval": ["--mode", "train_eval"],
    "visualize": ["--mode", "visualize", "--models", "pspnet", "--regenerate-predictions",
                  "--max-size", "320"],
    "predict": ["--mode", "predict", "--models", "segnet", "unet", "--tiled", "--eval-batch",
                "0", "--serving-preset", "optimized"],
}


@pytest.mark.parametrize("case", ARGVS)
def test_each_mode_hands_the_same_arguments(case, tmp_path, monkeypatch):
    argv = ARGVS[case] + ["--results-dir", "res"]
    calls = {"jax": [], "port": []}
    _record(japi, calls["jax"], monkeypatch)
    _record(api, calls["port"], monkeypatch)
    monkeypatch.setattr(jviz, "Visualizer", _NoFigures)
    monkeypatch.setattr(viz, "Visualizer", _NoFigures)
    for side, run in (("jax", lambda: jcli.main(argv)),
                      ("port", lambda: cli.main(argv, device="cpu"))):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        assert run() == 0
    assert calls["port"], case
    assert _comparable(calls["port"], True) == _comparable(calls["jax"], False)
    for name in ("evaluation_results.json", "evaluation_results.csv"):
        assert ((tmp_path / "port" / "res" / name).read_bytes()
                == (tmp_path / "jax" / "res" / name).read_bytes()), name


def test_manifest_prints_what_jax_prints(capsys):
    argv = ["--mode", "manifest", "--models", "enhanced_unet", "unet", "fcn"]
    assert jcli.main(argv) == 0
    want = capsys.readouterr().out
    assert cli.main(argv) == 0
    got = capsys.readouterr().out
    assert got == want and "efficientnet-b5" in got


def test_unknown_model_isolated(data_dir, tmp_path):
    results_dir = tmp_path / "results"
    rc = cli.main(["--mode", "eval", "--models", "not_a_model", "--data-dir", data_dir,
                   "--results-dir", str(results_dir), "--checkpoint-dir",
                   str(tmp_path / "ck"), "--max-size", "96"], device="cpu")
    assert rc == 0
    with open(results_dir / "evaluation_results.json") as f:
        assert json.load(f) == {"not_a_model": cli.ZERO_RESULTS}


def _recording_figures(monkeypatch):
    names = []

    def save(self, fig, filename, dpi=300):
        names.append(filename)
        import matplotlib.pyplot as plt

        plt.close(fig)

    monkeypatch.setattr(Visualizer, "_save_figure", save)
    return names


def test_eval_mode_end_to_end(data_dir, tmp_path, monkeypatch):
    figures = _recording_figures(monkeypatch)
    results_dir = tmp_path / "results"
    rc = cli.main(["--mode", "eval", "--models", "unet_basic", "--data-dir", data_dir,
                   "--results-dir", str(results_dir), "--checkpoint-dir",
                   str(tmp_path / "ck"), "--max-size", "96", "--dtype", "float32"],
                  device="cpu")
    assert rc == 0
    with open(results_dir / "evaluation_results.json") as f:
        results = json.load(f)
    assert list(results) == ["unet_basic"]
    assert all(np.isfinite(v) for v in results["unet_basic"].values()
               if isinstance(v, float))
    assert set(cli.ZERO_RESULTS) <= set(results["unet_basic"])
    assert (results_dir / "unet_basic" / "unet_basic_results.json").exists()
    with open(results_dir / "evaluation_results.csv", encoding="utf-8-sig") as f:
        assert f.readline().rstrip("\r\n").split(",") == [c for c, _ in cli.CSV_COLUMNS]
    assert "model_comparison" in figures


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_distributed_at_world_size_one(data_dir, tmp_path, monkeypatch):
    for key, value in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(_free_port())),
                       ("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0"),
                       ("LOCAL_WORLD_SIZE", "1")):
        monkeypatch.setenv(key, value)
    seen = []
    real_train = api.train_model

    def train(*args, **kwargs):
        seen.append((dist.is_initialized() and dist.get_world_size(), kwargs["device"]))
        return real_train(*args, **kwargs)

    monkeypatch.setattr(api, "train_model", train)
    monkeypatch.setattr(viz, "Visualizer", _NoFigures)
    ck = tmp_path / "ck"
    rc = cli.main(["--distributed", "--mode", "train", "--models", "unet_basic", "--epochs",
                   "1", "--data-dir", data_dir, "--results-dir", str(tmp_path / "res"),
                   "--checkpoint-dir", str(ck), "--max-size", "64", "--dtype", "float32"],
                  device="cpu")
    assert rc == 0
    assert seen == [(1, torch.device("cpu"))]
    assert not dist.is_initialized()
    assert sorted(os.listdir(ck / "unet_basic")) == ["best_model", "last_model"]


def test_eval_mode_without_matplotlib(data_dir, tmp_path, monkeypatch, capsys):
    from enhanced_unet_tpu_torch.viz import visualizer

    def no_matplotlib():
        raise ImportError("No module named 'matplotlib'")

    monkeypatch.setattr(visualizer, "_import_matplotlib", no_matplotlib)
    results_dir = tmp_path / "results"
    rc = cli.main(["--mode", "eval", "--models", "unet_basic", "--data-dir", data_dir,
                   "--results-dir", str(results_dir), "--checkpoint-dir",
                   str(tmp_path / "ck"), "--max-size", "96", "--dtype", "float32"],
                  device="cpu")
    out = capsys.readouterr().out
    assert rc == 0
    assert "warning: figures not rendered: No module named 'matplotlib'" in out
    assert "comparison visualization failed" in out
    with open(results_dir / "evaluation_results.json") as f:
        results = json.load(f)
    assert set(cli.ZERO_RESULTS) <= set(results["unet_basic"])
    assert sorted(os.listdir(results_dir / "unet_basic")) == ["unet_basic_results.json"]


def test_num_devices_isolates_a_spawned_failure(data_dir, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(api, "spawn", functools.partial(data_parallel.spawn, timeout=JOIN))
    monkeypatch.setattr(viz, "Visualizer", _NoFigures)
    ck = tmp_path / "ck"
    ck.mkdir()
    (ck / "linknet_basic").write_text("")    # each rank's makedirs of it raises
    rc = cli.main(["--mode", "train", "--num-devices", "2", "--models", "linknet_basic",
                   "unet_basic", "--epochs", "1", "--data-dir", data_dir, "--results-dir",
                   str(tmp_path / "res"), "--checkpoint-dir", str(ck), "--max-size", "64",
                   "--dtype", "float32"], device="cpu")
    out = capsys.readouterr().out
    assert rc == 0
    assert "Model linknet_basic failed" in out and "FileExistsError" in out
    assert sorted(os.listdir(ck / "unet_basic")) == ["best_model", "last_model"]
    with open(tmp_path / "res" / "evaluation_results.json") as f:
        assert list(json.load(f)) == ["linknet_basic", "unet_basic"]
