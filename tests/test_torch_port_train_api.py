"""PyTorch port vs JAX package: checkpoints and the training entry point.

- A checkpoint round trip is bitwise: parameters, running statistics, the
  AdamW moments and count, the step.  `meta.json` is the JAX package's,
  field for field, for the same history.
- `train_model` (the tiny flagship in fp32 on the CPU, supplied by
  monkeypatching `train.api.get_model`; a synthetic 96^2 dataset) writes
  the gate's checkpoints with JAX's history keys and finite gradient
  magnitudes, resumes where it stopped and skips training when asked,
  as `tests/test_e2e.py` holds the JAX package's; training over more than
  one device, not served yet, raises (`pretrained_dir` is held in
  `tests/test_torch_port_api_train.py`).
- `quick_val_miou` equals the JAX package's within 1e-4 on the same
  weights (a JAX tree carried into the port by `convert/jax_params.py`)
  and the same batches.
"""

import ast
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from synthdata import make_synthetic_dataset

from enhanced_unet_tpu import config as jconfig
from enhanced_unet_tpu.convert.torch_import import convert_enhanced_unet
from enhanced_unet_tpu.data.dataset import CellDataset as JCellDataset
from enhanced_unet_tpu.data.loader import BatchLoader as JBatchLoader
from enhanced_unet_tpu.models.enhanced_unet import EnhancedUNet as JEnhancedUNet
from enhanced_unet_tpu.train import api as japi
from enhanced_unet_tpu.train import checkpoint as jcheckpoint
from enhanced_unet_tpu.train import trainer as jtrainer
from enhanced_unet_tpu_torch import models
from enhanced_unet_tpu_torch.config import get_preset
from enhanced_unet_tpu_torch.convert import resume_from_jax
from enhanced_unet_tpu_torch.train import api
from enhanced_unet_tpu_torch.train.checkpoint import (
    checkpoint_exists,
    load_checkpoint,
    save_checkpoint,
)
from enhanced_unet_tpu_torch.train.trainer import create_train_state, make_train_step

torch.set_num_threads(1)
TINY = ("efficientnet-tiny", "efficientnet-tiny")


def _tiny(seed=0):
    model = models.get_model("enhanced_unet", dtype=torch.float32, device="cpu", seed=seed,
                             encoder_names=TINY)
    with torch.no_grad():  # sharper logits, so argmax sees every class
        for layer in (model.fusion_head[11], model.fusion_residual):
            layer.weight.mul_(20.0)
    return model


@pytest.fixture
def tiny_models(monkeypatch):
    real = models.get_model
    monkeypatch.setattr(api, "get_model",
                        lambda name, **kw: real(name, encoder_names=TINY, **kw))


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cells")
    make_synthetic_dataset(str(d), n_images=7, size=96)   # train 4, val 1, test 2
    return str(d)


def _cfg(data_dir, epochs, every):
    cfg = get_preset("enhanced_unet", num_epochs=epochs, data_dir=data_dir)
    return dataclasses.replace(cfg, num_epochs=epochs, eval_every_epochs=every)


def _run(data_dir, ckpt_dir, epochs, every, **kw):
    return api.train_model("enhanced_unet", data_dir=data_dir, num_epochs=epochs,
                           checkpoint_dir=ckpt_dir, max_size=96,
                           cfg=_cfg(data_dir, epochs, every), dtype=torch.float32,
                           device="cpu", log=lambda *a: None, **kw)


def _meta(path):
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)


# ---- checkpoints ------------------------------------------------------------

def _stepped_state(seed):
    cfg = get_preset("enhanced_unet")
    state = create_train_state(_tiny(seed), cfg, 4, device="cpu")
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.random((2, 32, 32, 3), dtype=np.float32))
    masks = torch.from_numpy(rng.integers(0, 3, (2, 32, 32)))
    valid = torch.ones(2, 32, 32, dtype=torch.bool)
    state, _ = make_train_step(cfg)(state, images, masks, valid,
                                    torch.Generator().manual_seed(0))
    return state


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    saved = _stepped_state(1)
    history = {"train_loss": [1.5, 1.25], "val_dice": [[0.5, 0.25]], "grad_norms": {"a.b": 0.1}}
    save_checkpoint(str(tmp_path / "ck"), saved, 2, 0.75, 1.25, history)
    assert checkpoint_exists(str(tmp_path / "ck"))
    assert not checkpoint_exists(str(tmp_path / "none"))
    fresh = create_train_state(_tiny(2), get_preset("enhanced_unet"), 4, device="cpu")
    restored, meta = load_checkpoint(str(tmp_path / "ck"), fresh)
    assert restored.model is fresh.model and restored.step == saved.step == 1
    for (n, a), (m, b) in zip(saved.model.state_dict().items(),
                              restored.model.state_dict().items()):
        assert n == m and a.dtype == b.dtype
        assert torch.equal(a, b), n
    assert restored.opt_state.count == saved.opt_state.count == 1
    for moments in ("mu", "nu"):
        ours, ref = getattr(restored.opt_state, moments), getattr(saved.opt_state, moments)
        assert ours.keys() == ref.keys()
        assert all(torch.equal(ours[k], ref[k]) and ours[k].dtype == ref[k].dtype
                   for k in ref)
    assert meta == {"epoch": 2, "best_miou": 0.75, "best_loss": 1.25, "history": history}


def test_meta_json_equals_jax(tmp_path):
    history = {"train_loss": [2.0, 1.5], "val_miou": [0.25], "val_dice": [[0.5, 0.125]],
               "epoch_axis": [2]}
    save_checkpoint(str(tmp_path / "ours"), _stepped_state(3), 2, 0.25, 1.5, history)
    jstate = jtrainer.TrainState(step=jnp.int32(1), params={"w": jnp.ones(3)},
                                 batch_stats={"m": jnp.zeros(3)},
                                 opt_state={"c": jnp.zeros(1)}, apply_fn=None, tx=None)
    jcheckpoint.save_checkpoint(str(tmp_path / "ref"), jstate, 2, 0.25, 1.5, history)
    assert _meta(str(tmp_path / "ours")) == _meta(str(tmp_path / "ref"))


# ---- train_model ------------------------------------------------------------

def _jax_history_keys():
    """The keys of the history dict that the JAX `train_model` starts."""
    with open(japi.__file__) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "history" and isinstance(node.value, ast.Dict)):
            return {k.value for k in node.value.keys}
    raise AssertionError("no history dict in the JAX train_model")


def test_train_model_gate_history_and_checkpoints(data_dir, tmp_path, tiny_models):
    ckpt = _run(data_dir, str(tmp_path), epochs=2, every=1)
    assert ckpt == os.path.join(str(tmp_path), "enhanced_unet", "best_model")
    last = os.path.join(os.path.dirname(ckpt), "last_model")
    for path in (ckpt, last):
        assert checkpoint_exists(path)
        assert os.path.exists(os.path.join(path, "state.pt"))
    meta = _meta(last)
    history = meta["history"]
    assert set(history) == _jax_history_keys() | {"grad_norms"}
    assert meta["epoch"] == 2 and len(history["train_loss"]) == 2
    assert history["epoch_axis"] == [1, 2] and len(history["val_miou"]) == 2
    assert all(np.isfinite(history["train_loss"]))
    assert all(np.isfinite(v) for v in history["grad_norms"].values())
    assert len(history["grad_norms"]) > 100 and any(v > 0 for v in history["grad_norms"].values())
    assert _meta(ckpt)["best_miou"] == max(history["val_miou"]) or max(history["val_miou"]) == 0
    saved = torch.load(os.path.join(last, "state.pt"), weights_only=True)
    assert saved["step"] == 2 * 2 == saved["opt_state"]["count"]   # 4 train images, batch 2


def test_train_model_resumes(data_dir, tmp_path, tiny_models):
    p1 = _run(data_dir, str(tmp_path), epochs=2, every=1)
    last = os.path.join(os.path.dirname(p1), "last_model")
    meta1 = _meta(last)
    _run(data_dir, str(tmp_path), epochs=3, every=1, resume=True)
    meta2 = _meta(last)
    assert meta2["epoch"] == 3 and len(meta2["history"]["train_loss"]) == 3
    assert meta2["history"]["train_loss"][:2] == meta1["history"]["train_loss"]
    assert meta2["history"]["epoch_axis"] == [1, 2, 3]
    saved = torch.load(os.path.join(last, "state.pt"), weights_only=True)
    assert saved["step"] == 3 * 2


def test_train_model_skips_training(data_dir, tmp_path, tiny_models):
    p1 = _run(data_dir, str(tmp_path), epochs=1, every=1, use_full_evaluator_gate=False)
    mtime = os.path.getmtime(os.path.join(p1, "meta.json"))
    p2 = _run(data_dir, str(tmp_path), epochs=1, every=1, skip_training=True)
    assert p1 == p2
    assert os.path.getmtime(os.path.join(p2, "meta.json")) == mtime


@pytest.mark.parametrize("kw,item", [({"num_devices": 2}, "item 5")])
def test_train_model_refuses_what_it_does_not_serve(data_dir, tmp_path, kw, item):
    with pytest.raises(NotImplementedError, match=item):
        _run(data_dir, str(tmp_path), epochs=1, every=1, **kw)


# ---- quick_val_miou against JAX ---------------------------------------------

def test_quick_val_miou_equals_jax(data_dir):
    cfg = get_preset("enhanced_unet")
    jcfg = jconfig.get_preset("enhanced_unet")
    # the JAX tree of seeded weights, carried into a port state by
    # convert/jax_params.py (weights, running statistics, optimizer state)
    params, stats = convert_enhanced_unet(
        {k: v.clone() for k, v in _tiny(4).state_dict().items()}, TINY)
    opt_state = jtrainer.make_optimizer(jcfg, 4).init(params)
    jstate = jtrainer.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                 batch_stats=stats, opt_state=opt_state,
                                 apply_fn=JEnhancedUNet(encoder_names=TINY,
                                                        dtype=jnp.float32).apply,
                                 tx=None)
    state = create_train_state(_tiny(9), cfg, 4, device="cpu")
    state = resume_from_jax(state, params, stats, opt_state, TINY)

    files = sorted(f for f in os.listdir(data_dir) if f.endswith(".jpg"))
    batches = list(JBatchLoader(JCellDataset(data_dir, max_size=96, files=files), 3,
                                (96, 96)))
    assert [b["n_real"] for b in batches] == [3, 3, 1]
    ref = japi.quick_val_miou(jstate, jcfg, batches)
    ours = api.quick_val_miou(state, cfg, [
        {"images": torch.from_numpy(np.asarray(b["images"])),
         "semantic_masks": torch.from_numpy(np.asarray(b["semantic_masks"])).long(),
         "valid_mask": torch.from_numpy(np.asarray(b["valid_mask"])),
         "n_real": b["n_real"]} for b in batches])
    assert set(ours) == set(ref)
    for k in ref:
        assert abs(ours[k] - ref[k]) <= 1e-4, (k, ours[k], ref[k])
    # random weights: some pixels of each image leave the background, so
    # the compared matrices are not the trivial all-background one
    assert 0 < ref["sem_background_iou"] < 1
    assert api.quick_val_miou(state, cfg, []) == japi.quick_val_miou(jstate, jcfg, [])
