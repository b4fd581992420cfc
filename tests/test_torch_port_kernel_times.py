"""`kernel_times.py` on the CPU: its recorder on one tiled request with TTA
of the efficientnet-tiny flagship, served through the plain versions, the
cells it serves (those whose kind serves requests) and the timer's refusal
to run without a card.  No JAX.
"""

import json
import shutil

import numpy as np
import pytest
import torch

import kernel_times
from enhanced_unet_tpu_torch.models import get_model
from enhanced_unet_tpu_torch.models.blocks import SCSEBlock
from enhanced_unet_tpu_torch.models.encoders import MBConvBlock
from enhanced_unet_tpu_torch.ops.kernels import conv_fused
from enhanced_unet_tpu_torch.train.evaluator import Evaluator

torch.set_num_threads(1)


def test_the_recorder_sees_each_kernel_call_of_a_tiled_request(monkeypatch):
    model = get_model("enhanced_unet", dtype=torch.float32, device="cpu", seed=2,
                      encoder_names=("efficientnet-tiny", "efficientnet-tiny"))
    # what the tiny model's blocks give each kernel: every scSE call of the
    # decoder, the fused (stage-0) and the dilated MBConv blocks' calls, and
    # each 3x3 ConvBNAct's call of K2's plain version (its route on the CPU)
    called = {"S1": 0, "K1": 0, "D1": 0, "K2": 0}

    def hook(kernel):
        return lambda *_: called.__setitem__(kernel, called[kernel] + 1)

    for m in model.modules():
        if isinstance(m, SCSEBlock):
            m.register_forward_hook(hook("S1"))
        elif isinstance(m, MBConvBlock) and (m.fused or m.dilation > 1):
            m.register_forward_hook(hook("K1" if m.fused else "D1"))
    plain = conv_fused.fused_conv3x3_bn_relu_plain
    monkeypatch.setattr(conv_fused, "fused_conv3x3_bn_relu_plain",
                        lambda *a, **k: (hook("K2")(), plain(*a, **k))[1])
    images = np.random.default_rng(0).random((1, 96, 128, 3), dtype=np.float32)
    ev = Evaluator(model, "enhanced_unet", enable_tta=True, device="cpu", verbose=False,
                   tiled=True, tile=64, overlap=16)
    with torch.inference_mode():
        rec = kernel_times.record(lambda: ev.predict_semantic_masks_tiled(images))
    assert rec.launches() == {**called, "D2": 0}
    assert min(called.values()) > 0 and called["S1"] % 3 == 0     # three TTA forwards
    # the recorder is removed, and each shape holds what a timing needs
    assert kernel_times.blocks.scse_parts is kernel_times.scse.scse_parts
    for kernel, by_shape in rec.calls.items():
        for shape, (count, call) in by_shape.items():
            assert count > 0 and call.bound_s > 0 and call.inputs, (kernel, shape)
    s1 = [call for _, call in rec.calls["S1"].values()]
    xs = [torch.randn(shape).to(dtype) for shape, _, dtype in s1[0].inputs]
    assert torch.equal(s1[0].kernel(*xs), s1[0].plain(*xs))


def test_the_timer_serves_the_cells_whose_kind_serves(tmp_path, capsys):
    # the manifest's cells, and one whose kind has no `serve` (a train
    # kind, say): that one is named on a line of its own, skipped
    base = kernel_times.ROOT / "portbench"
    for sub in ("configs", "traffic", "kinds"):
        shutil.copytree(base / sub, tmp_path / sub)
    (tmp_path / "traffic" / "train_step.json").write_text(json.dumps({"kind": "train"}))
    (tmp_path / "kinds" / "train.py").write_text("class Workload:\n    pass\n")
    bench = json.loads((kernel_times.ROOT / "BENCHMARK.json").read_text())
    served = [w["name"] for w in bench["workloads"]]
    bench["workloads"].append({"name": "a_train_cell", "config": bench["workloads"][0]["config"],
                               "traffic": "train_step", "chips": 1})
    cells = kernel_times.served_cells(bench, tmp_path)
    assert [cell.name for cell, _ in cells] == served
    assert all(hasattr(workload, "serve") for _, workload in cells)
    skipped = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert skipped == [{"cell": "a_train_cell", "skipped": "its kind 'train' serves no request"}]


def test_the_timer_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        kernel_times.main()
