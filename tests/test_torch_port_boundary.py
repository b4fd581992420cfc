"""The PyTorch port's package boundary and device rule.

- Importing every module of `enhanced_unet_tpu_torch` loads neither JAX nor
  any module of the JAX package (checked in a fresh interpreter, since this
  test process has imported JAX already).  Module names are matched exactly
  or by `name + "."`: the port's own name starts with `enhanced_unet_tpu`.
- With no card, the entry points refuse to run instead of using the CPU;
  a kernel wrapper runs its plain version only for a CPU tensor, and a
  missing `nvcc` raises.
- The port's presets equal the JAX package's, field for field.
"""

import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from enhanced_unet_tpu import config as jconfig
from enhanced_unet_tpu_torch import config
from enhanced_unet_tpu_torch.models import EnhancedUNet, get_model
from enhanced_unet_tpu_torch.train.evaluator import Evaluator

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import sys
before = set(sys.modules)
import enhanced_unet_tpu_torch
import enhanced_unet_tpu_torch.config, enhanced_unet_tpu_torch.device
import enhanced_unet_tpu_torch.models, enhanced_unet_tpu_torch.convert
import enhanced_unet_tpu_torch.ops.resize, enhanced_unet_tpu_torch.ops.preprocess
import enhanced_unet_tpu_torch.ops.tta, enhanced_unet_tpu_torch.ops.thresholding
import enhanced_unet_tpu_torch.ops.kernels.build
import enhanced_unet_tpu_torch.ops.kernels.conv_fused
import enhanced_unet_tpu_torch.ops.kernels.mbconv
import enhanced_unet_tpu_torch.train.evaluator
loaded = set(sys.modules) - before
for pkg in ("jax", "jaxlib", "flax", "enhanced_unet_tpu"):
    bad = sorted(m for m in loaded if m == pkg or m.startswith(pkg + "."))
    assert not bad, bad
assert "enhanced_unet_tpu_torch.ops.kernels.mbconv" in loaded
print("BOUNDARY OK")
"""


def test_import_loads_no_jax_and_nothing_of_the_jax_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BOUNDARY OK" in out.stdout


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        get_model("enhanced_unet")
    with pytest.raises(RuntimeError, match="CUDA"):
        get_model("enhanced_unet", device="cuda")
    model = EnhancedUNet(encoder_names=("efficientnet-tiny", "efficientnet-tiny"))
    with pytest.raises(RuntimeError, match="CUDA"):
        Evaluator(model, "enhanced_unet")


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    from enhanced_unet_tpu_torch.ops.kernels import build

    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "DEFAULT_NVCC", tmp_path / "no-nvcc")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load("mbconv")


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
