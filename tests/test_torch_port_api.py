"""PyTorch port vs JAX package: the user-facing entry points of
`train/api.py`: `evaluate_model`, `predict_model` and `visualize_model`
(`tests/test_torch_port_api_train.py` holds `train_and_evaluate` and
`train_model(pretrained_dir=...)`).

Both packages serve the tiny flagship (efficientnet-tiny encoders, fp32, on
the CPU), supplied by monkeypatching `get_model` in both API modules, with
the same weights: the port's seeded model, carried into a JAX
`TrainState` by the JAX package's `convert_enhanced_unet` and written with
its own `save_checkpoint` (the JAX package's `.pth` import fixes the
encoders at b5/b4, so it cannot take tiny ones).  The JAX entry points
restore their checkpoint into a template state; its flax `init` takes
over a minute on one CPU core, so the template is built from converted
weights instead (`japi._build_state` patched: the same tree, other
values, all overwritten by the restore).  Tolerances:

- `evaluate_model`: every metric within 0.02 of JAX's with each side's own
  forward (the port's CLAHE is within a few grey levels of JAX's jitted
  one), within 1e-12 when both are handed the same predicted masks; the
  results JSON has the same keys; a reference-format `.pth` written from
  the port's model (with the smp encoders' unused classifier heads)
  evaluates to exactly the port checkpoint's numbers;
- `predict_model`: the CSV and the mask and overlay PNGs equal JAX's, byte
  for byte, on the same predicted masks (mixed sizes, resized, batched
  and tiled);
- the figure suite of `evaluate_model` and `visualize_model` asks for the
  same files as JAX's (rendering patched out in both; the real rendering
  is held in `tests/test_torch_port_viz_render.py`).
"""

import csv
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from synthdata import make_synthetic_dataset
from test_torch_port_pretrained import effnet_head

from enhanced_unet_tpu import config as jconfig
from enhanced_unet_tpu.convert import torch_import as jimport
from enhanced_unet_tpu.convert.torch_import import convert_enhanced_unet
from enhanced_unet_tpu.train import api as japi
from enhanced_unet_tpu.train import checkpoint as jcheckpoint
from enhanced_unet_tpu.train import trainer as jtrainer
from enhanced_unet_tpu.models.enhanced_unet import EnhancedUNet as JEnhancedUNet
from enhanced_unet_tpu.train.evaluator import Evaluator as JEvaluator
from enhanced_unet_tpu.viz import visualizer as jviz
from enhanced_unet_tpu_torch import models
from enhanced_unet_tpu_torch.config import get_preset
from enhanced_unet_tpu_torch.postprocess import semantic_to_instances
from enhanced_unet_tpu_torch.train import api
from enhanced_unet_tpu_torch.train.checkpoint import save_checkpoint
from enhanced_unet_tpu_torch.train.evaluator import _METRIC_KEYS, Evaluator
from enhanced_unet_tpu_torch.train.trainer import create_train_state
from enhanced_unet_tpu_torch.viz import visualizer as viz

torch.set_num_threads(1)
TINY = ("efficientnet-tiny", "efficientnet-tiny")
HISTORY = {"train_loss": [2.0, 1.5, 1.25], "val_loss": [1.5], "val_miou": [0.25],
           "val_live_iou": [0.375], "val_dead_iou": [0.125], "val_dice": [[0.5, 0.25]],
           "learning_rate": [1e-3, 2e-3, 1.5e-3], "epoch_axis": [3],
           "epoch_time_sec": [1.0, 0.5, 0.5], "images_per_sec": [4.0, 8.0, 8.0],
           "grad_norms": {"unetpp.encoder._conv_stem.weight": 0.01, "fusion_residual.weight": 0.5}}


def _silent(*a):
    pass


@dataclasses.dataclass
class JaxStateStub:
    """What the JAX package's `load_torch_checkpoint` and
    `initialize_pretrained` read and replace of a `TrainState`."""

    params: dict
    batch_stats: dict

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _tiny(seed=0):
    model = models.get_model("enhanced_unet", dtype=torch.float32, device="cpu", seed=seed,
                             encoder_names=TINY)
    with torch.no_grad():  # sharper logits, so the cascade sees real decisions
        for layer in (model.fusion_head[11], model.fusion_residual):
            layer.weight.mul_(20.0)
    return model


def _jax_state(model, cfg, steps=1, dtype=jnp.float32):
    """A JAX `TrainState` of the port model's weights, as the JAX
    `create_train_state` builds it (optimizer state included)."""
    params, stats = convert_enhanced_unet(
        {k: v.clone() for k, v in model.state_dict().items()}, TINY)
    tx = jtrainer.make_optimizer(cfg, steps)
    return jtrainer.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                               batch_stats=stats, opt_state=tx.init(params),
                               apply_fn=JEnhancedUNet(encoder_names=TINY, dtype=dtype).apply,
                               tx=tx)


@pytest.fixture(autouse=True)
def tiny_models(monkeypatch):
    real = models.get_model
    monkeypatch.setattr(api, "get_model", lambda name, **kw: real(name, encoder_names=TINY, **kw))
    monkeypatch.setattr(japi, "_build_state", lambda name, cfg, steps, pad_shape, dtype:
                        _jax_state(_tiny(99), cfg, steps, dtype))


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cells")
    make_synthetic_dataset(str(d), n_images=14, size=96, cells_per_image=6, seed=2)
    return str(d)                                  # train 9, val 2, test 3


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """The same weights as a port checkpoint, a JAX checkpoint and a
    reference `.pth`."""
    root = tmp_path_factory.mktemp("ckpt")
    model = _tiny(3)
    state = create_train_state(model, get_preset("enhanced_unet"), 1, device="cpu")
    save_checkpoint(str(root / "port"), state, 3, 0.25, 1.5, HISTORY)
    jstate = _jax_state(model, jconfig.get_preset("enhanced_unet"))
    jcheckpoint.save_checkpoint(str(root / "jax"), jstate, 3, 0.25, 1.5, HISTORY)
    sd = dict(model.state_dict())
    g = torch.Generator().manual_seed(0)
    for prefix in ("unetpp.encoder.", "deeplab.encoder."):
        enc = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
        for k, v in effnet_head(enc, g).items():
            if not k.startswith("_fc."):            # smp deletes the classifier
                sd[prefix + k] = v
    torch.save({"epoch": 3, "model_state_dict": sd, "optimizer_state_dict": {},
                "best_miou": 0.25, "best_loss": 1.5,
                "history": {"train_loss": [np.float64(2.0)], "val_iou": [np.zeros(3)]}},
               root / "reference.pth")
    return {k: str(root / k) for k in ("port", "jax")} | {"pth": str(root / "reference.pth")}


def _evaluate_both(data_dir, checkpoints, tmp_path, **kw):
    ours = api.evaluate_model("enhanced_unet", data_dir, checkpoints["port"],
                              results_dir=str(tmp_path / "port"), max_size=96,
                              dtype=torch.float32, log=_silent, device="cpu", **kw)
    ref = japi.evaluate_model("enhanced_unet", data_dir, checkpoints["jax"],
                              results_dir=str(tmp_path / "jax"), max_size=96,
                              dtype=jnp.float32, log=_silent, **kw)
    return ours, ref


def _results_json(root):
    with open(os.path.join(root, "enhanced_unet", "enhanced_unet_results.json")) as f:
        return json.load(f)


def test_evaluate_model_equals_jax(data_dir, checkpoints, tmp_path):
    ours, ref = _evaluate_both(data_dir, checkpoints, tmp_path, generate_visualizations=False)
    assert set(ours) == set(ref) == set(_METRIC_KEYS)
    assert all(np.isfinite(v) for v in ours.values())
    for k in ref:
        assert abs(ours[k] - ref[k]) <= 0.02, (k, ours[k], ref[k])
    assert ours["pred_live_count"] + ours["pred_dead_count"] > 0, ours
    saved = _results_json(tmp_path / "port")
    assert saved == ours and saved.keys() == _results_json(tmp_path / "jax").keys()


def _mask_of(img):
    """A deterministic mask of an image: its grey levels in three bands
    (dark: dead, middle: live, bright: background)."""
    grey = np.asarray(img, np.float32).mean(-1)
    return np.where(grey < 0.45, 2, np.where(grey < 0.6, 1, 0)).astype(np.int32)


def _patch_predictions(monkeypatch):
    for cls in (Evaluator, JEvaluator):
        monkeypatch.setattr(cls, "predict_semantic_mask", lambda self, img: _mask_of(img))
        monkeypatch.setattr(cls, "predict_semantic_masks",
                            lambda self, imgs: np.stack([_mask_of(i) for i in imgs]))


def test_evaluate_model_metrics_equal_jax_on_the_same_masks(data_dir, checkpoints, tmp_path,
                                                            monkeypatch):
    _patch_predictions(monkeypatch)
    ours, ref = _evaluate_both(data_dir, checkpoints, tmp_path, generate_visualizations=False,
                               eval_batch_size=2)
    for k in ref:
        assert abs(ours[k] - ref[k]) <= 1e-12, (k, ours[k], ref[k])
    assert ours["pred_live_count"] > 0 and ours["pred_dead_count"] > 0, ours


def _record_figures(monkeypatch):
    saved = {"port": [], "jax": []}
    for pkg, module in (("port", viz), ("jax", jviz)):
        def save(self, fig, filename, dpi=300, _pkg=pkg, _module=module):
            saved[_pkg].append(filename)
            _module.plt.close(fig)
        monkeypatch.setattr(module.Visualizer, "_save_figure", save)
    return saved


def test_evaluate_model_figures_equal_jax(data_dir, checkpoints, tmp_path, monkeypatch):
    _patch_predictions(monkeypatch)
    # the probabilities feed the ROC, PR and calibration charts
    monkeypatch.setattr(Evaluator, "predict_probs", lambda self, img: np.full(
        img.shape[:2] + (3,), 1 / 3, np.float32) + 0.1 * np.eye(3, dtype=np.float32)[
            _mask_of(img)])
    monkeypatch.setattr(JEvaluator, "predict_probs", Evaluator.predict_probs)
    saved = _record_figures(monkeypatch)
    logs = {"port": [], "jax": []}
    api.evaluate_model("enhanced_unet", data_dir, checkpoints["port"],
                       results_dir=str(tmp_path / "port"), max_size=96, dtype=torch.float32,
                       log=logs["port"].append, device="cpu")
    japi.evaluate_model("enhanced_unet", data_dir, checkpoints["jax"],
                        results_dir=str(tmp_path / "jax"), max_size=96, dtype=jnp.float32,
                        log=logs["jax"].append)
    assert saved["port"] == saved["jax"]
    assert len(saved["port"]) == 4 + 19                  # history charts + prediction charts
    assert not [m for m in logs["port"] if "warning" in m], logs["port"]
    names = {p: sorted(os.listdir(tmp_path / p / "enhanced_unet")) for p in ("port", "jax")}
    assert names["port"] == names["jax"]
    csv_name = "enhanced_unet_cell_count_comparison.csv"
    with open(tmp_path / "port" / "enhanced_unet" / csv_name) as a, \
            open(tmp_path / "jax" / "enhanced_unet" / csv_name) as b:
        assert a.read() == b.read()


def test_reference_pth_evaluates_like_the_port_checkpoint(data_dir, checkpoints, tmp_path):
    kw = dict(max_size=96, dtype=torch.float32, device="cpu", generate_visualizations=False)
    logs = []
    from_pth = api.evaluate_model("enhanced_unet", data_dir, checkpoints["pth"],
                                  results_dir=str(tmp_path / "a"), log=logs.append, **kw)
    from_dir = api.evaluate_model("enhanced_unet", data_dir, checkpoints["port"],
                                  results_dir=str(tmp_path / "b"), log=_silent, **kw)
    assert from_pth == from_dir
    assert any("Imported torch checkpoint" in m and "_conv_head.weight" in m for m in logs)


def test_load_torch_checkpoint_report(checkpoints):
    from enhanced_unet_tpu_torch.convert import load_torch_checkpoint

    state = create_train_state(_tiny(9), get_preset("enhanced_unet"), 1, device="cpu")
    out, report = load_torch_checkpoint(checkpoints["pth"], state, "enhanced_unet")
    assert out is state and set(report) == {"imported", "skipped", "meta"}
    assert report["skipped"] == sorted(
        f"{p}.encoder.{k}" for p in ("deeplab", "unetpp")
        for k in ["_bn1.bias", "_bn1.num_batches_tracked", "_bn1.running_mean",
                  "_bn1.running_var", "_bn1.weight", "_conv_head.weight"])
    assert report["meta"]["epoch"] == 3 and report["meta"]["best_miou"] == 0.25
    assert report["meta"]["history"]["train_loss"] == [2.0]
    want = _tiny(3).state_dict()
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    sd = torch.load(checkpoints["pth"], weights_only=False)["model_state_dict"]
    sd["fusion_residual.weight"] = sd["fusion_residual.weight"][:, :1]
    with pytest.raises(ValueError, match="another shape"):
        load_torch_checkpoint({"model_state_dict": sd}, state, "enhanced_unet")
    assert torch.equal(state.model.state_dict()["unetpp.encoder._conv_stem.weight"],
                       want["unetpp.encoder._conv_stem.weight"])
    # a zoo model takes the checkpoint's `model.encoder.*` alone (here none):
    # the report is the JAX package's, and no tensor changes
    unet = create_train_state(models.get_model("unet", dtype=torch.float32, device="cpu"),
                              get_preset("unet"), 1, device="cpu")
    before = {k: v.clone() for k, v in unet.model.state_dict().items()}
    _, report = load_torch_checkpoint({"model_state_dict": sd, "epoch": 3}, unet, "unet")
    _, jreport = jimport.load_torch_checkpoint({"model_state_dict": sd, "epoch": 3},
                                               JaxStateStub({}, {}), "unet")
    assert report == jreport
    assert report["imported"] == [] and report["skipped"] == [
        "attention_gate", "deeplab", "fusion_head", "fusion_residual", "unetpp"]
    assert all(torch.equal(v, before[k]) for k, v in unet.model.state_dict().items())


@pytest.fixture(scope="module")
def images_dir(tmp_path_factory):
    """Bare micrographs of three sizes, JPEG and PNG: at max_size 96 the
    128 x 160 ones are resized to 64 x 96 and join the 64 x 96 one."""
    d = tmp_path_factory.mktemp("bare")
    rng = np.random.default_rng(5)
    for i, (h, w, ext) in enumerate([(96, 96, "jpg"), (128, 160, "png"), (96, 96, "png"),
                                     (128, 160, "jpg"), (96, 96, "jpeg"), (64, 96, "jpg"),
                                     (128, 160, "png")]):
        yy, xx = np.mgrid[:h, :w]
        img = 160 + 20 * np.sin(yy / 7.0) + rng.normal(0, 8, (h, w))
        for _ in range(6):
            cy, cx, r = rng.uniform(8, h - 8), rng.uniform(8, w - 8), rng.uniform(4, 9)
            img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = rng.choice([90, 130])
        rgb = np.clip(np.repeat(img[..., None], 3, -1), 0, 255).astype(np.uint8)
        Image.fromarray(rgb).save(d / f"img_{i}.{ext}")
    (d / "notes.txt").write_text("not an image")
    return str(d)


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("tiled,batch_size", [(False, 2), (False, 8), (True, 8)])
def test_predict_model_equals_jax(images_dir, checkpoints, tmp_path, monkeypatch, tiled,
                                  batch_size):
    _patch_predictions(monkeypatch)
    chunks = {"port": [], "jax": []}
    for pkg, cls in (("port", Evaluator), ("jax", JEvaluator)):
        batched = cls.predict_semantic_masks
        monkeypatch.setattr(cls, "predict_semantic_masks", lambda self, imgs, _p=pkg, _b=batched: (
            chunks[_p].append(len(imgs)), _b(self, imgs))[1])
    kw = dict(max_size=96, tiled=tiled, tile=64, overlap=16, batch_size=batch_size, log=_silent)
    ours = api.predict_model("enhanced_unet", images_dir, checkpoints["port"],
                             results_dir=str(tmp_path / "port"), dtype=torch.float32,
                             device="cpu", **kw)
    ref = japi.predict_model("enhanced_unet", images_dir, checkpoints["jax"],
                             results_dir=str(tmp_path / "jax"), dtype=jnp.float32, **kw)
    assert ours["predictions"] == ref["predictions"] and len(ours["predictions"]) == 7
    assert chunks["port"] == chunks["jax"]
    # groups: 96 x 96 (3 images) and 64 x 96 (4); a chunk of one goes alone
    assert chunks["port"] == ([] if tiled else [2, 2, 2] if batch_size == 2 else [3, 4])
    out = {p: os.path.join(str(tmp_path), p, "enhanced_unet", "predictions")
           for p in ("port", "jax")}
    files = sorted(os.listdir(out["port"]))
    assert files == sorted(os.listdir(out["jax"])) and len(files) == 2 * 7 + 1
    for name in files:
        with open(os.path.join(out["port"], name), "rb") as a, \
                open(os.path.join(out["jax"], name), "rb") as b:
            assert a.read() == b.read(), name
    rows = _read_csv(os.path.join(out["port"], "predictions.csv"))
    assert rows[0] == ["filename", "live_count", "dead_count", "total_count",
                       "viability_percent", "live_pixels", "dead_pixels"]
    assert [r[0] for r in rows[1:]] == sorted(f for f in os.listdir(images_dir)
                                              if not f.endswith(".txt"))
    with Image.open(os.path.join(out["port"], "img_1_mask.png")) as im:
        assert im.size == (96, 64)                 # 160 x 128 snapped under 96
    assert sum(int(r[3]) for r in rows[1:]) > 0


def test_predict_model_serves_the_model(images_dir, checkpoints, tmp_path):
    """The real forward on the CPU: each row's counts are those of
    `semantic_to_instances` on the mask the Evaluator gives for the same
    image, batched or alone."""
    out = api.predict_model("enhanced_unet", images_dir, checkpoints["port"],
                            results_dir=str(tmp_path), max_size=96, dtype=torch.float32,
                            batch_size=3, log=_silent, device="cpu")
    ev = Evaluator(_tiny(3), "enhanced_unet", device="cpu", verbose=False)
    for row in out["predictions"][:3]:
        arr = np.asarray(Image.open(os.path.join(images_dir, row["filename"])).convert("RGB"))
        from enhanced_unet_tpu_torch.data.dataset import _resize_image, snap_to_multiple

        h, w = snap_to_multiple(*arr.shape[:2], 96)
        if (h, w) != arr.shape[:2]:
            arr = _resize_image(arr, (w, h))
        mask = ev.predict_semantic_mask(arr.astype(np.float32) / 255.0)
        labels = semantic_to_instances(mask)[1]
        assert row["live_count"] == sum(1 for label in labels if label == 0)
        assert row["dead_count"] == sum(1 for label in labels if label == 1)
        assert row["live_pixels"] == int((mask == 1).sum())


def test_predict_model_refuses_an_empty_directory(tmp_path):
    with pytest.raises(ValueError, match="no images"):
        api.predict_model("enhanced_unet", str(tmp_path), device="cpu", log=_silent)


def test_visualize_model_returns_the_saved_results(data_dir, checkpoints, tmp_path,
                                                   monkeypatch):
    saved = _record_figures(monkeypatch)
    results = {k: 0.5 for k in _METRIC_KEYS}
    for pkg in ("port", "jax"):
        os.makedirs(tmp_path / pkg / "enhanced_unet")
        with open(tmp_path / pkg / "enhanced_unet" / "enhanced_unet_results.json", "w") as f:
            json.dump(results, f)
    ours = api.visualize_model("enhanced_unet", data_dir, checkpoint_path=checkpoints["port"],
                               results_dir=str(tmp_path / "port"), log=_silent)
    # the same meta.json for both (the JAX checkpoint's has its history
    # keys sorted, which orders the CSV's columns)
    ref = japi.visualize_model("enhanced_unet", data_dir, checkpoint_path=checkpoints["port"],
                               results_dir=str(tmp_path / "jax"), log=_silent)
    assert ours == ref == results
    assert saved["port"] == saved["jax"] and len(saved["port"]) == 4
    hist = "enhanced_unet_training_history.csv"
    with open(tmp_path / "port" / "enhanced_unet" / hist) as a, \
            open(tmp_path / "jax" / "enhanced_unet" / hist) as b:
        assert a.read() == b.read()
    assert api.visualize_model("enhanced_unet", data_dir, checkpoint_path=str(tmp_path / "x"),
                               results_dir=str(tmp_path / "none"), log=_silent) == {}


def test_visualize_model_regenerates_the_prediction_figures(data_dir, checkpoints, tmp_path,
                                                            monkeypatch):
    _patch_predictions(monkeypatch)
    saved = _record_figures(monkeypatch)
    api.visualize_model("enhanced_unet", data_dir, checkpoint_path=checkpoints["port"],
                        results_dir=str(tmp_path), regenerate_predictions=True, max_size=96,
                        dtype=torch.float32, log=_silent, device="cpu")
    assert len(saved["port"]) == 4 + 19 and "enhanced_unet_roc_curves" in saved["port"]
