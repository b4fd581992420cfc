"""The PyTorch port's package boundary and device rule.

- Importing every module of `enhanced_unet_tpu_torch`, as
  `pkgutil.walk_packages` finds them, loads neither JAX nor any module of
  the JAX package (checked in a fresh interpreter, since this test process
  has imported JAX already).  Module names are matched exactly or by
  `name + "."`: the port's own name starts with `enhanced_unet_tpu`.
- No `import` statement in the port's files, in `kernel_times.py` or in the
  card tests' helpers, at any depth, names JAX or the JAX package (imports
  inside functions run only when called, so the probe alone would miss
  them).
- The port imports no `cv2`: neither the probe nor any `import` statement
  loads it (the dataset computes OpenCV's polygons and resizes itself).
  Importing the port loads no Pillow either: the dataset imports it when
  it reads its first image; nor matplotlib, which the first `Visualizer`
  imports.
- With no card, the entry points and the CLI refuse to run instead of using the CPU
  (`optimizer_state_from_jax` too, whose default was the CPU; and
  `evaluate_model`, `predict_model`, `train_and_evaluate` and
  `visualize_model` when it serves predictions), writing nothing; a kernel
  wrapper runs its plain version only for a CPU tensor, and a missing
  `nvcc` raises.
- The port's presets equal the JAX package's, field for field.
"""

import ast
import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from enhanced_unet_tpu import config as jconfig
from enhanced_unet_tpu_torch import config
from enhanced_unet_tpu_torch.data import BatchLoader, CellDataset
from enhanced_unet_tpu_torch.models import EnhancedUNet, get_model
from enhanced_unet_tpu_torch.train import api
from enhanced_unet_tpu_torch.train.api import train_model
from enhanced_unet_tpu_torch.train.evaluator import Evaluator

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
before = set(sys.modules)
import enhanced_unet_tpu_torch
walked = [m.name for m in pkgutil.walk_packages(enhanced_unet_tpu_torch.__path__,
                                                "enhanced_unet_tpu_torch.")]
for name in walked:
    importlib.import_module(name)
loaded = set(sys.modules) - before
for pkg in ("jax", "jaxlib", "flax", "enhanced_unet_tpu", "cv2", "PIL", "matplotlib"):
    bad = sorted(m for m in loaded if m == pkg or m.startswith(pkg + "."))
    assert not bad, bad
for name in ("enhanced_unet_tpu_torch.ops.kernels.mbconv",
             "enhanced_unet_tpu_torch.ops.kernels.depthwise",
             "enhanced_unet_tpu_torch.benchmarks.mbconv_instr",
             "enhanced_unet_tpu_torch.postprocess.instances",
             "enhanced_unet_tpu_torch.native", "enhanced_unet_tpu_torch.ops.tiling",
             "enhanced_unet_tpu_torch.ops.preprocess", "enhanced_unet_tpu_torch.ops.augment",
             "enhanced_unet_tpu_torch.data.dataset", "enhanced_unet_tpu_torch.data.loader",
             "enhanced_unet_tpu_torch.train.checkpoint", "enhanced_unet_tpu_torch.train.api",
             "enhanced_unet_tpu_torch.viz.visualizer", "enhanced_unet_tpu_torch.utils.profiler",
             "enhanced_unet_tpu_torch.convert.pretrained",
             "enhanced_unet_tpu_torch.convert.torch_import",
             "enhanced_unet_tpu_torch.models.unet", "enhanced_unet_tpu_torch.models.segnet",
             "enhanced_unet_tpu_torch.models.fcn", "enhanced_unet_tpu_torch.models.pspnet",
             "enhanced_unet_tpu_torch.models.linknet", "enhanced_unet_tpu_torch.cli",
             "enhanced_unet_tpu_torch.parallel", "enhanced_unet_tpu_torch.parallel.mesh",
             "enhanced_unet_tpu_torch.parallel.data_parallel",
             "enhanced_unet_tpu_torch.parallel.tiled",
             "enhanced_unet_tpu_torch.parallel.spatial",
             "enhanced_unet_tpu_torch.parallel.tensor_parallel",
             "enhanced_unet_tpu_torch.parallel.torch_function",
             "enhanced_unet_tpu_torch.ops.partition",
             "enhanced_unet_tpu_torch.train.trainer",
             "enhanced_unet_tpu_torch.train.evaluator"):
    assert name in walked and name in loaded, name
print("BOUNDARY OK", len(walked))
"""


def _imported_names(path):
    """Every module name an `import` statement in the file names, at any
    depth (imports inside functions included)."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


_PORT_FILES = sorted(
    os.path.relpath(os.path.join(d, f), REPO)
    for d, _, files in os.walk(os.path.join(REPO, "enhanced_unet_tpu_torch"))
    for f in files if f.endswith(".py")) + ["kernel_times.py", "tests/card_cases.py",
                                            "tests/spatial_ranks.py", "tests/tp_ranks.py"]


def test_import_loads_no_jax_and_nothing_of_the_jax_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BOUNDARY OK" in out.stdout


@pytest.mark.parametrize("path", _PORT_FILES)
def test_no_import_of_jax_or_the_jax_package(path):
    for name in _imported_names(os.path.join(REPO, path)):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "enhanced_unet_tpu"), (path, name)


@pytest.mark.parametrize("path", _PORT_FILES)
def test_no_import_of_cv2(path):
    for name in _imported_names(os.path.join(REPO, path)):
        assert name.split(".")[0] != "cv2", (path, name)


def _optax_state():
    """An optax chain(clip, adamw) state of the tiny flagship's tree."""
    import jax.numpy as jnp
    import optax

    from enhanced_unet_tpu.convert.torch_import import convert_enhanced_unet

    tiny = ("efficientnet-tiny", "efficientnet-tiny")
    model = get_model("enhanced_unet", dtype=torch.float32, device="cpu", encoder_names=tiny)
    params, _ = convert_enhanced_unet(model.state_dict(), tiny)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-3, mu_dtype=jnp.bfloat16))
    return tx.init(params), tiny


def test_optimizer_state_from_jax_raises_without_a_card(monkeypatch):
    from enhanced_unet_tpu_torch.convert import optimizer_state_from_jax

    opt_state, tiny = _optax_state()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        optimizer_state_from_jax(opt_state, tiny)


def test_optimizer_state_from_jax_on_the_cpu_when_asked():
    from enhanced_unet_tpu_torch.convert import optimizer_state_from_jax

    opt_state, tiny = _optax_state()
    state = optimizer_state_from_jax(opt_state, tiny, torch.bfloat16, device="cpu")
    assert state.count == 0 and len(state.mu) == len(state.nu) > 0
    assert {t.device.type for t in [*state.mu.values(), *state.nu.values()]} == {"cpu"}
    assert {t.dtype for t in state.mu.values()} == {torch.bfloat16}


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        get_model("enhanced_unet")
    with pytest.raises(RuntimeError, match="CUDA"):
        get_model("enhanced_unet", device="cuda")
    for name in ("unet", "segnet", "linknet_basic"):
        with pytest.raises(RuntimeError, match="CUDA"):
            get_model(name)
    model = EnhancedUNet(encoder_names=("efficientnet-tiny", "efficientnet-tiny"))
    with pytest.raises(RuntimeError, match="CUDA"):
        Evaluator(model, "enhanced_unet")
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchLoader(CellDataset(str(tmp_path), files=[]), 2, (64, 64))
    with pytest.raises(RuntimeError, match="CUDA"):
        train_model("enhanced_unet", data_dir=str(tmp_path),
                    checkpoint_dir=str(tmp_path / "ck"))
    assert not os.path.exists(tmp_path / "ck")


def test_make_mesh_2d_raises_without_a_card(monkeypatch, tmp_path):
    from enhanced_unet_tpu_torch.parallel import make_mesh_2d

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh_2d(1, 1, init_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh_2d(1, 1, device="cuda", init_dir=str(tmp_path))
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("mode", ["eval", "train", "predict", "visualize"])
def test_cli_raises_without_a_card(monkeypatch, tmp_path, mode):
    from enhanced_unet_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--mode", mode, "--models", "unet_basic", "--data-dir", str(tmp_path)])
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("entry", ["evaluate_model", "predict_model", "visualize_model",
                                   "train_and_evaluate"])
def test_user_entry_points_raise_without_a_card(monkeypatch, tmp_path, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "images").mkdir()
    (tmp_path / "images" / "a.png").write_bytes(b"")
    call = {
        "evaluate_model": lambda: api.evaluate_model("enhanced_unet", str(tmp_path)),
        "predict_model": lambda: api.predict_model("enhanced_unet", str(tmp_path / "images")),
        "visualize_model": lambda: api.visualize_model("enhanced_unet", str(tmp_path),
                                                       regenerate_predictions=True),
        "train_and_evaluate": lambda: api.train_and_evaluate("enhanced_unet", str(tmp_path)),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
    assert sorted(os.listdir(tmp_path)) == ["images"]


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    from enhanced_unet_tpu_torch.ops.kernels import build

    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "DEFAULT_NVCC", tmp_path / "no-nvcc")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load("mbconv")


@pytest.mark.parametrize("n,h,w,ok", [(65535, 1, 1, True), (65536, 1, 1, False),
                                      (75, 512, 512, True), (8192, 512, 512, False)])
def test_kernel_grid_limit(n, h, w, ok):
    # K1 launches the batch as gridDim.z, K2 counts tiles in `int`
    from enhanced_unet_tpu_torch.ops.kernels import build

    if ok:
        build.check_grid(n, h, w, "k")
    else:
        with pytest.raises(ValueError, match="beyond the kernels' grid"):
            build.check_grid(n, h, w, "k")


def test_kernel_wrappers_refuse_other_devices():
    # neither CPU (the plain version) nor CUDA (the kernel): no fallback
    from enhanced_unet_tpu_torch.models.encoders import MBConvBlock
    from enhanced_unet_tpu_torch.ops.kernels import conv_fused, mbconv

    meta = torch.device("meta")
    x = torch.empty(1, 8, 8, 4, device=meta)
    with pytest.raises(ValueError, match="device"):
        conv_fused.fused_conv3x3_bn_relu(x, torch.empty(3, 3, 4, 4, device=meta),
                                         torch.empty(4, device=meta),
                                         torch.empty(4, device=meta))
    p = MBConvBlock(4, 4, 1, 1, 3, fused=True).fold()
    with pytest.raises(ValueError, match="device"):
        mbconv.mbconv_infer_nchw(torch.empty(1, 4, 8, 8, device=meta), p,
                                 residual=True)


@pytest.mark.parametrize("name", jconfig.MODEL_NAMES)
def test_presets_match_jax(name):
    assert config.MODEL_NAMES == jconfig.MODEL_NAMES
    ours = config.get_preset(name, num_epochs=30, data_dir="d")
    ref = jconfig.get_preset(name, num_epochs=30, data_dir="d")
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert (ours.warmup_epochs, ours.cosine_t0) == (ref.warmup_epochs, ref.cosine_t0)
    assert config.SERVING_OPTIMIZED_KWARGS == jconfig.SERVING_OPTIMIZED_KWARGS
