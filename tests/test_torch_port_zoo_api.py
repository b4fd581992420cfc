"""The zoo through the port's entry points, against the JAX package where it
has the same entry:

- `train_model` then `predict_model` on the CPU (fp32) with `unet_basic`
  and `linknet` at full width, on a synthetic 96^2 dataset: the best and
  last checkpoints, finite losses, a row and two PNGs per image;
- `initialize_pretrained` of the four ResNet models from seeded
  torchvision-layout files (every stage, `fc.*`): the port's encoder after
  the load, read by JAX's `convert_resnet`, equals the subtree the JAX
  package grafts from the same file, exactly;
- `load_torch_checkpoint` of a reference-format `.pth` (the port's state
  dict under the reference's names, plus a ResNet encoder's unused stages)
  for the ResNet models and segnet: the report equals the JAX package's,
  and the imported encoder equals JAX's, exactly;
- `resume_from_jax` of every zoo model from a JAX tree and an optax
  `chain(clip, adamw)` state whose moments are made in the JAX tree from
  each weight (mu = 2w + 1, nu = w^2 + 1/2): weights, running statistics
  and the count carried, and each port parameter's moments those of its
  own JAX weight, so a moment carried onto another parameter of the same
  shape shows.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from synthdata import make_synthetic_dataset
from test_torch_port_api import JaxStateStub
from test_torch_port_pretrained import torchvision_state_dict
from test_torch_port_zoo import ZOO, _variables

from enhanced_unet_tpu import config as jconfig
from enhanced_unet_tpu.convert import pretrained as jpretrained
from enhanced_unet_tpu.convert import torch_import as jimport
from enhanced_unet_tpu.train import trainer as jtrainer
from enhanced_unet_tpu_torch.config import get_preset
from enhanced_unet_tpu_torch.convert import (
    initialize_pretrained,
    load_torch_checkpoint,
    required_weights,
    resume_from_jax,
    state_dict_from_jax,
)
from enhanced_unet_tpu_torch.models import get_model
from enhanced_unet_tpu_torch.train import api
from enhanced_unet_tpu_torch.train.checkpoint import checkpoint_exists
from enhanced_unet_tpu_torch.train.trainer import create_train_state

torch.set_num_threads(1)
RESNET_MODELS = ("unet", "fcn", "pspnet", "linknet")
DEPTH = {"unet": 5, "fcn": 4, "pspnet": 4, "linknet": 3}


def _tree_equal(a, b):
    la, ta = jax.tree.flatten(a)
    lb, tb = jax.tree.flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _state(name, seed=0):
    model = get_model(name, dtype=torch.float32, device="cpu", seed=seed)
    return create_train_state(model, get_preset(name), 1, device="cpu")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cells")
    make_synthetic_dataset(str(d), n_images=7, size=96, seed=6)   # train 4, val 1, test 2
    return str(d)


@pytest.mark.parametrize("name", ["unet_basic", "linknet"])
def test_train_model_then_predict_model(name, data_dir, tmp_path):
    cfg = dataclasses.replace(get_preset(name, num_epochs=1, data_dir=data_dir),
                              num_epochs=1, eval_every_epochs=1)
    best = api.train_model(name, data_dir, 1, checkpoint_dir=str(tmp_path / "ck"),
                           max_size=96, cfg=cfg, dtype=torch.float32, log=lambda *a: None,
                           device="cpu")
    assert checkpoint_exists(best)
    assert checkpoint_exists(str(tmp_path / "ck" / name / "last_model"))
    images = tmp_path / "images"
    images.mkdir()
    for f in sorted(os.listdir(data_dir)):
        if f.endswith(".jpg"):
            os.link(os.path.join(data_dir, f), images / f)
    out = api.predict_model(name, str(images), best, results_dir=str(tmp_path / "res"),
                            max_size=96, dtype=torch.float32, log=lambda *a: None,
                            device="cpu")
    names = sorted(os.listdir(images))
    assert [r["filename"] for r in out["predictions"]] == names
    assert all(r["live_count"] >= 0 and 0 <= r["viability_percent"] <= 100
               for r in out["predictions"])
    assert sorted(os.listdir(out["save_dir"])) == sorted(
        [f"{n[:-4]}_{k}.png" for n in names for k in ("mask", "overlay")]
        + ["predictions.csv"])


def _jax_stub(name):
    """A JAX state of `name`'s tree (numpy leaves), for the JAX package's
    `initialize_pretrained` and `load_torch_checkpoint`."""
    _, v = _variables(name)
    return JaxStateStub(v["params"], v.get("batch_stats", {}))


@pytest.mark.parametrize("name", RESNET_MODELS)
def test_initialize_pretrained_resnet_matches_jax(name):
    variant = next(iter(required_weights(name)))
    sd = torchvision_state_dict(variant, 7)
    state = _state(name, 1)
    _, imported = initialize_pretrained(state, name, state_dicts={variant: sd},
                                        log=lambda *a: None)
    jstate, jimported = jpretrained.initialize_pretrained(
        _jax_stub(name), name, state_dicts={variant: sd}, log=lambda *a: None)
    assert imported == jimported == [variant]
    enc = state.model.model["encoder"].state_dict()
    params, stats = jimport.convert_resnet(enc, variant, DEPTH[name])
    _tree_equal(params, jstate.params["ResNetEncoder_0"])
    _tree_equal(stats, jstate.batch_stats["ResNetEncoder_0"])


@pytest.mark.parametrize("name", RESNET_MODELS + ("segnet",))
def test_load_torch_checkpoint_zoo_report_matches_jax(name, tmp_path):
    src = get_model(name, dtype=torch.float32, device="cpu", seed=4).state_dict()
    if name in RESNET_MODELS:
        # a reference encoder keeps every torchvision stage; the forward
        # calls only the first ones
        full = torchvision_state_dict(next(iter(required_weights(name))), 8)
        src.update({f"model.encoder.{k}": v for k, v in full.items()
                    if f"model.encoder.{k}" not in src and not k.startswith("fc.")})
    ckpt = {"epoch": 5, "model_state_dict": src, "best_miou": 0.5, "best_loss": 0.75,
            "history": {"train_loss": [1.0, 0.5]}}
    path = str(tmp_path / f"{name}.pth")
    torch.save(ckpt, path)
    state = _state(name, 2)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    _, report = load_torch_checkpoint(path, state, name)
    jstate, jreport = jimport.load_torch_checkpoint(path, _jax_stub(name), name)
    assert report == jreport
    assert report["meta"] == {"epoch": 5, "best_miou": 0.5, "best_loss": 0.75,
                              "history": {"train_loss": [1.0, 0.5]}}
    now = state.model.state_dict()
    if name in RESNET_MODELS:
        assert report["imported"] == ["model.encoder."] and report["skipped"] == ["model"]
        for k, v in now.items():
            want = src[k] if k.startswith("model.encoder.") else before[k]
            assert torch.equal(v, want), k
        enc = state.model.model["encoder"].state_dict()
        params, stats = jimport.convert_resnet(enc, state.model.model["encoder"].variant,
                                               DEPTH[name])
        _tree_equal(params, jstate.params["ResNetEncoder_0"])
        _tree_equal(stats, jstate.batch_stats["ResNetEncoder_0"])
    else:
        assert report["imported"] == [] and report["skipped"] == sorted(
            {k.split(".")[0] for k in src})
        assert all(torch.equal(v, before[k]) for k, v in now.items())


def _with_adam(opt_state, **fields):
    """`opt_state` with the fields of its `ScaleByAdamState` replaced."""
    if all(hasattr(opt_state, a) for a in ("count", "mu", "nu")):
        return opt_state._replace(**fields)
    if isinstance(opt_state, tuple):
        subs = [_with_adam(sub, **fields) for sub in opt_state]
        return type(opt_state)(*subs) if hasattr(opt_state, "_fields") else tuple(subs)
    return opt_state


@pytest.mark.parametrize("name", ZOO)
def test_resume_from_jax_carries_a_zoo_state(name):
    _, v = _variables(name)
    params, stats = v["params"], v.get("batch_stats", {})
    tx = jtrainer.make_optimizer(jconfig.get_preset(name), 4)
    opt_state = _with_adam(tx.init(jax.tree.map(jnp.asarray, params)),
                           count=np.asarray(3, np.int32),
                           mu=jax.tree.map(lambda w: 2 * np.asarray(w) + 1, params),
                           nu=jax.tree.map(lambda w: np.asarray(w) * np.asarray(w) + 0.5,
                                           params))
    state = _state(name, 3)
    out = resume_from_jax(state, params, stats, opt_state, model_name=name)
    assert out.step == out.opt_state.count == 3
    want = state_dict_from_jax(params, stats, model_name=name)
    for k, t in state.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(t, want[k]), k
    named = dict(state.model.named_parameters())
    assert sorted(out.opt_state.mu) == sorted(out.opt_state.nu) == sorted(named)
    for n, p in named.items():
        w = p.detach()
        mu = out.opt_state.mu[n]
        assert torch.equal(mu, (2 * w + 1).to(mu.dtype)), n
        assert torch.equal(out.opt_state.nu[n], w * w + 0.5), n

