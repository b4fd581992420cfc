"""The port's training entry points end to end on the CPU (the tiny
flagship in fp32, a synthetic 96^2 dataset, `get_model` monkeypatched as
in `tests/test_torch_port_api.py`):

- `train_and_evaluate` trains one epoch, then evaluates the best
  checkpoint on the same device into the results JSON and the figure suite
  (rendering patched out);
- `train_model(pretrained_dir=...)` loads the encoders from the directory's
  upstream-layout files (SHA-prefixed names, checked) before the first
  step, and not when it resumes.
"""

import dataclasses
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from synthdata import make_synthetic_dataset
from test_torch_port_api import _record_figures, _results_json, _silent, _tiny, tiny_models  # noqa: F401
from test_torch_port_pretrained import upstream_state_dicts

from enhanced_unet_tpu_torch.config import get_preset
from enhanced_unet_tpu_torch.convert import pretrained
from enhanced_unet_tpu_torch.train import api
from enhanced_unet_tpu_torch.train.evaluator import _METRIC_KEYS

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cells")
    make_synthetic_dataset(str(d), n_images=7, size=96, seed=4)   # train 4, val 1, test 2
    return str(d)


def _cfg(data_dir, epochs):
    return dataclasses.replace(get_preset("enhanced_unet", num_epochs=epochs,
                                          data_dir=data_dir),
                               num_epochs=epochs, eval_every_epochs=1)


def test_train_and_evaluate_runs_one_epoch(data_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    saved = _record_figures(monkeypatch)
    out = api.train_and_evaluate("enhanced_unet", data_dir, 1, checkpoint_dir="ck",
                                 max_size=96, cfg=_cfg(data_dir, 1), dtype=torch.float32,
                                 use_full_evaluator_gate=False, log=_silent, device="cpu")
    assert set(out) == set(_METRIC_KEYS) and all(np.isfinite(v) for v in out.values())
    with open(tmp_path / "ck" / "enhanced_unet" / "best_model" / "meta.json") as f:
        assert len(json.load(f)["history"]["train_loss"]) == 1
    assert _results_json(tmp_path / "results") == out
    assert "enhanced_unet_training_curves" in saved["port"]


def test_train_model_loads_pretrained_encoders_unless_resuming(data_dir, tmp_path, monkeypatch):
    weights = tmp_path / "weights"
    weights.mkdir()
    files = upstream_state_dicts(_tiny(0), seed=11)
    manifest = dict(pretrained.WEIGHT_MANIFEST)
    for variant, sd in files.items():
        torch.save(sd, weights / "tmp.pth")
        h8 = hashlib.sha256((weights / "tmp.pth").read_bytes()).hexdigest()[:8]
        os.rename(weights / "tmp.pth", weights / f"{variant}-{h8}.pth")
        manifest[variant] = dict(manifest[variant], file=f"{variant}-{h8}.pth",
                                 sha256_prefix=h8)
    monkeypatch.setattr(pretrained, "WEIGHT_MANIFEST", manifest)
    loaded = []
    real = api.initialize_pretrained

    def spy(state, *a, **kw):
        out = real(state, *a, **kw)
        enc = state.model.unetpp.encoder.state_dict()
        loaded.append(all(torch.equal(enc[k], v) for k, v in files["efficientnet-b5"].items()
                          if k in enc))
        return out

    monkeypatch.setattr(api, "initialize_pretrained", spy)
    logs = []
    kw = dict(data_dir=data_dir, checkpoint_dir=str(tmp_path / "ck"), max_size=96,
              dtype=torch.float32, use_full_evaluator_gate=False, device="cpu",
              pretrained_dir=str(weights))
    api.train_model("enhanced_unet", num_epochs=1, cfg=_cfg(data_dir, 1), log=logs.append, **kw)
    assert loaded == [True]
    assert [m for m in logs if m.startswith("initialized")] == [
        "initialized unetpp.encoder from efficientnet-b5 ImageNet weights",
        "initialized deeplab.encoder from efficientnet-b4 ImageNet weights"]
    api.train_model("enhanced_unet", num_epochs=2, cfg=_cfg(data_dir, 2), resume=True,
                    log=_silent, **kw)
    assert loaded == [True]
