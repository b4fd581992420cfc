"""The port's ImageNet-pretrained encoders (`convert/pretrained.py`)
against the JAX package's.

- The manifest, `required_weights` and `verify_weight_file` equal the JAX
  package's.
- The full-width flagship (EfficientNet-B5 and -B4) takes seeded
  upstream-layout state dicts exactly: every encoder tensor equals the
  file's, every other tensor is unchanged, the classifier (`_fc.*`) is
  ignored, and a missing, extra or misshapen key raises before any
  tensor is written.
- The JAX package converts an upstream file with `convert_efficientnet`
  (its encoders' variants are fixed at b5/b4), so the port's load is held
  against it through that converter: the converter on the port encoder's
  state dict after the load equals the converter on the file, at full and
  at tiny width.
- Weight files are read from a directory, their SHA256 prefix checked.
- Models trained from scratch raise `ValueError` (JAX's message); the
  ResNet models (unet, fcn, pspnet, linknet) take seeded torchvision-layout
  files, `fc.*` and all four stages, exactly into `model.encoder` (the
  stages past the model's depth dropped, `convert_resnet` never reads
  them); `tests/test_torch_port_zoo_api.py` holds them against the JAX
  package's load.
"""

import hashlib
import os

import numpy as np
import pytest
import torch

import jax

from enhanced_unet_tpu import config as jconfig
from enhanced_unet_tpu.convert import pretrained as jpretrained
from enhanced_unet_tpu.convert.torch_import import convert_efficientnet
from enhanced_unet_tpu_torch.config import get_preset
from enhanced_unet_tpu_torch.convert import pretrained
from enhanced_unet_tpu_torch.convert import (
    WEIGHT_MANIFEST,
    initialize_pretrained,
    required_weights,
    verify_weight_file,
)
from enhanced_unet_tpu_torch.models import get_model
from enhanced_unet_tpu_torch.train.trainer import create_train_state

torch.set_num_threads(1)
TINY = ("efficientnet-tiny", "efficientnet-tiny")
ENCODERS = {"efficientnet-b5": "unetpp.encoder", "efficientnet-b4": "deeplab.encoder"}


def _state(encoder_names=None, seed=0):
    kw = {"encoder_names": encoder_names} if encoder_names else {}
    model = get_model("enhanced_unet", dtype=torch.float32, device="cpu", seed=seed, **kw)
    return create_train_state(model, get_preset("enhanced_unet"), 1, device="cpu")


def upstream_state_dicts(model, seed):
    """Seeded efficientnet-pytorch-layout files for the model's two
    encoders: the encoders' own keys and shapes, plus the classifier head
    (a 1x1 conv to 4x the last block's width, its BatchNorm, the linear
    layer)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for variant, path in ENCODERS.items():
        sd = {}
        for k, v in model.get_submodule(path).state_dict().items():
            if k.endswith("num_batches_tracked"):
                sd[k] = torch.randint(0, 1000, (), generator=g)
            elif k.endswith("running_var"):
                sd[k] = torch.rand(v.shape, generator=g) + 0.5
            else:
                sd[k] = torch.randn(v.shape, generator=g)
        out[variant] = {**sd, **effnet_head(sd, g)}
    return out


def effnet_head(encoder_sd, g):
    last = max(int(k.split(".")[1]) for k in encoder_sd if k.startswith("_blocks."))
    cin = encoder_sd[f"_blocks.{last}._project_conv.weight"].shape[0]
    c = 4 * cin
    return {"_conv_head.weight": torch.randn(c, cin, 1, 1, generator=g),
            "_bn1.weight": torch.rand(c, generator=g), "_bn1.bias": torch.randn(c, generator=g),
            "_bn1.running_mean": torch.randn(c, generator=g),
            "_bn1.running_var": torch.rand(c, generator=g) + 0.5,
            "_bn1.num_batches_tracked": torch.tensor(7),
            "_fc.weight": torch.randn(1000, c, generator=g),
            "_fc.bias": torch.randn(1000, generator=g)}


def _head(key):
    return key.startswith(("_conv_head.", "_bn1.", "_fc."))


def _snapshot(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_manifest_equals_jax():
    assert WEIGHT_MANIFEST == jpretrained.WEIGHT_MANIFEST
    names = list(jconfig.MODEL_NAMES) + [f"{m}_basic" for m in jconfig.MODEL_NAMES]
    for name in names + ["no_such_model"]:
        assert required_weights(name) == jpretrained.required_weights(name), name
    assert set(required_weights("enhanced_unet")) == set(ENCODERS)


def test_verify_weight_file_equals_jax(tmp_path):
    payload = b"synthetic-weights-payload"
    h8 = hashlib.sha256(payload).hexdigest()[:8]
    for name, want in ((f"efficientnet-b5-{h8}.pth", True),
                       ("efficientnet-b5-b6417697.pth", False)):
        (tmp_path / name).write_bytes(payload)
        assert verify_weight_file(str(tmp_path / name)) is want
        assert jpretrained.verify_weight_file(str(tmp_path / name)) is want
    (tmp_path / "weights.pth").write_bytes(payload)
    for fn in (verify_weight_file, jpretrained.verify_weight_file):
        with pytest.raises(ValueError, match="torch.hub-style"):
            fn(str(tmp_path / "weights.pth"))


@pytest.fixture(scope="module")
def full_width_load():
    state = _state(seed=1)
    before = _snapshot(state.model)
    files = upstream_state_dicts(state.model, seed=2)
    logs = []
    out, imported = initialize_pretrained(state, "enhanced_unet", state_dicts=files,
                                          log=logs.append)
    return state, out, imported, before, files, logs


def test_full_width_load_is_exact(full_width_load):
    state, out, imported, before, files, logs = full_width_load
    assert out is state and imported == ["efficientnet-b5", "efficientnet-b4"]
    assert logs == [f"initialized {p} from {v} ImageNet weights" for v, p in ENCODERS.items()]
    after = state.model.state_dict()
    loaded = 0
    for k, v in after.items():
        prefix = next((p for p in ENCODERS.values() if k.startswith(p + ".")), None)
        if prefix is None:
            assert torch.equal(v, before[k]), k
            continue
        variant = next(var for var, p in ENCODERS.items() if p == prefix)
        assert torch.equal(v, files[variant][k[len(prefix) + 1:]].to(v.dtype)), k
        loaded += 1
    n_files = sum(len([k for k in sd if not _head(k)]) for sd in files.values())
    assert loaded == n_files > 1000
    # the optimizer holds the same parameter tensors, now pretrained
    stem = state.model.unetpp.encoder._conv_stem.weight
    assert any(p is stem for p in state.model.parameters())


@pytest.mark.parametrize("variant", list(ENCODERS))
def test_full_width_load_equals_jax_converter(full_width_load, variant):
    state, _, _, _, files, _ = full_width_load
    sd = state.model.get_submodule(ENCODERS[variant]).state_dict()
    ours, ref = (_leaves(t) for t in (convert_efficientnet(sd, variant),
                                      convert_efficientnet(files[variant], variant)))
    assert ours.keys() == ref.keys() and len(ours) > 500
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def test_tiny_load_equals_jax_converter():
    state = _state(TINY, seed=3)
    files = upstream_state_dicts(state.model, seed=4)
    initialize_pretrained(state, "enhanced_unet", state_dicts=files, log=lambda *a: None)
    for variant, path in ENCODERS.items():
        sd = state.model.get_submodule(path).state_dict()
        ours = _leaves(convert_efficientnet(sd, "efficientnet-tiny"))
        ref = _leaves(convert_efficientnet(files[variant], "efficientnet-tiny"))
        assert ours.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def _missing(sd):
    sd.pop("_blocks.0._bn1.running_mean")


def _extra(sd):
    sd["_blocks.0._bn1.extra"] = torch.zeros(3)


def _misshapen(sd):
    sd["_conv_stem.weight"] = sd["_conv_stem.weight"][:, :2]


@pytest.mark.parametrize("edit,match", [(_missing, "missing"), (_extra, "unexpected"),
                                        (_misshapen, "another shape")])
@pytest.mark.parametrize("variant", list(ENCODERS))
def test_a_wrong_file_raises_and_writes_nothing(edit, match, variant):
    state = _state(TINY, seed=5)
    files = upstream_state_dicts(state.model, seed=6)
    edit(files[variant])
    before = _snapshot(state.model)
    with pytest.raises(ValueError, match=match):
        initialize_pretrained(state, "enhanced_unet", state_dicts=files, log=lambda *a: None)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_full_width_files_do_not_fit_tiny_encoders():
    big = upstream_state_dicts(_state(seed=1).model, seed=2)
    state = _state(TINY, seed=5)
    with pytest.raises(ValueError, match="efficientnet-b5 into unetpp.encoder"):
        initialize_pretrained(state, "enhanced_unet", state_dicts=big, log=lambda *a: None)


def _write_files(tmp_path, files, names):
    for variant, sd in files.items():
        torch.save(sd, tmp_path / names[variant])


def test_files_from_a_directory_with_their_sha_checked(tmp_path, monkeypatch):
    state = _state(TINY, seed=7)
    files = upstream_state_dicts(state.model, seed=8)
    _write_files(tmp_path, files, {v: WEIGHT_MANIFEST[v]["file"] for v in files})
    with pytest.raises(ValueError, match="SHA256"):
        initialize_pretrained(state, "enhanced_unet", weights_dir=str(tmp_path),
                              log=lambda *a: None)
    initialize_pretrained(state, "enhanced_unet", weights_dir=str(tmp_path), verify=False,
                          log=lambda *a: None)
    enc = state.model.deeplab.encoder.state_dict()
    assert all(torch.equal(enc[k], v) for k, v in files["efficientnet-b4"].items()
               if not _head(k))
    # a copy named after its own SHA256 prefix verifies
    manifest = {}
    for variant in files:
        src = tmp_path / WEIGHT_MANIFEST[variant]["file"]
        h8 = hashlib.sha256(src.read_bytes()).hexdigest()[:8]
        name = f"{variant}-{h8}.pth"
        (tmp_path / name).write_bytes(src.read_bytes())
        manifest[variant] = dict(WEIGHT_MANIFEST[variant], file=name, sha256_prefix=h8)
    monkeypatch.setattr(pretrained, "WEIGHT_MANIFEST", manifest)
    state2 = _state(TINY, seed=9)
    _, imported = initialize_pretrained(state2, "enhanced_unet", weights_dir=str(tmp_path),
                                        log=lambda *a: None)
    assert imported == ["efficientnet-b5", "efficientnet-b4"]
    with pytest.raises(FileNotFoundError, match="download it from"):
        initialize_pretrained(state2, "enhanced_unet", weights_dir=str(tmp_path / "none"))


@pytest.mark.parametrize("name", ["segnet", "unet_basic", "enhanced_unet_basic"])
def test_models_from_scratch_raise_like_jax(name):
    with pytest.raises(ValueError) as ours:
        initialize_pretrained(None, name, state_dicts={})
    with pytest.raises(ValueError) as ref:
        jpretrained.initialize_pretrained(None, name, state_dicts={})
    assert str(ours.value) == str(ref.value)


def torchvision_state_dict(variant, seed):
    """A seeded torchvision-layout ResNet file: every stage and the
    classifier `fc`, no `num_batches_tracked` (torchvision's files predate
    it)."""
    from enhanced_unet_tpu_torch.models.encoders import ResNetEncoder

    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in ResNetEncoder(variant, depth=5).state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        sd[k] = (torch.rand(v.shape, generator=g) + 0.5 if k.endswith("running_var")
                 else torch.randn(v.shape, generator=g))
    width = 2048 if variant == "resnet50" else 512
    sd["fc.weight"] = torch.randn(1000, width, generator=g)
    sd["fc.bias"] = torch.randn(1000, generator=g)
    return sd


@pytest.mark.parametrize("name", ["unet", "fcn", "pspnet", "linknet"])
def test_resnet_models_load_torchvision_files(name):
    variant = next(iter(required_weights(name)))
    model = get_model(name, dtype=torch.float32, device="cpu", seed=2)
    state = create_train_state(model, get_preset(name), 1, device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    sd = torchvision_state_dict(variant, 5)
    _, imported = initialize_pretrained(state, name, state_dicts={variant: sd},
                                        log=lambda *a: None)
    assert imported == [variant]
    enc = model.model["encoder"]
    own = enc.state_dict()
    assert all(torch.equal(v, sd[k]) for k, v in own.items()
               if not k.endswith("num_batches_tracked"))
    assert {k.split(".")[0] for k in sd} - {k.split(".")[0] for k in own} == (
        {"fc"} | {f"layer{i}" for i in range(enc.n_stages + 1, 5)})
    for k, v in model.state_dict().items():
        if not k.startswith("model.encoder."):
            assert torch.equal(v, before[k]), k
    bad = dict(sd)
    bad["conv1.weight"] = bad["conv1.weight"][:, :2]
    with pytest.raises(ValueError, match="another shape"):
        initialize_pretrained(state, name, state_dicts={variant: bad})
