"""The dilated depthwise kernel's plain version and its routing, on the CPU.

`ops/kernels/depthwise.py` `dw_dilated_bn_silu_nhwc` runs the eval-mode
dilated `MBConvBlock`s' depthwise conv, BN and SiLU (the DeepLab encoder's
stages 5-6 at output stride 16).  On the CPU the wrapper runs its plain
version; these tests hold it against the stock sequence it replaces (`F.pad`,
the grouped conv, eval-mode BN, SiLU) in fp32 at both kernel sizes, maps
smaller than the halo, widths that are and are not multiples of 8, NCHW and
channels_last inputs; the block's routing (eval mode outside a partitioned
run takes the kernel; train mode and a partitioned run keep the stock path);
the fold cache and its `kernels.dw_fold` counter, which it shares with
K1's `fold` (tensor parallelism drops both; a fold from channel slices keeps
nothing and counts every call); and what the wrapper
refuses, on the CPU as on the card.  The kernel itself is held against the
plain version on the card (`tests/test_torch_port_gpu.py`).
"""

import types

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from enhanced_unet_tpu_torch.models import encoders, init_random_weights_
from enhanced_unet_tpu_torch.models.encoders import MBConvBlock
from enhanced_unet_tpu_torch.ops import partition
from enhanced_unet_tpu_torch.ops.kernels import depthwise
from enhanced_unet_tpu_torch.ops.kernels.depthwise import (
    DwFolded,
    dw_dilated_bn_silu_nhwc,
    dw_dilated_bn_silu_nhwc_plain,
    fold_dw_bn,
)
from enhanced_unet_tpu_torch.parallel.tensor_parallel import shard_params_tp
from enhanced_unet_tpu_torch.utils import profiler

torch.set_num_threads(1)


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-6)).item()


def _conv_bn(c, k, seed):
    g = torch.Generator().manual_seed(seed)
    conv = torch.nn.Conv2d(c, c, k, groups=c, dilation=2, bias=False)
    bn = torch.nn.BatchNorm2d(c, eps=1e-3).eval()
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) * 0.3)
        bn.weight.copy_(torch.rand(c, generator=g) + 0.5)
        bn.bias.copy_(torch.randn(c, generator=g) * 0.2)
        bn.running_mean.copy_(torch.randn(c, generator=g) * 0.2)
        bn.running_var.copy_(torch.rand(c, generator=g) + 0.5)
    return conv, bn


def _stock(x, conv, bn, d):
    """The sequence the kernel replaces: pad, grouped conv, eval BN, SiLU."""
    p = d * (conv.kernel_size[0] // 2)
    y = F.conv2d(F.pad(x, [p, p, p, p]), conv.weight, None, 1, 0, d, x.shape[1])
    return F.silu(F.batch_norm(y, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                               False, 0.0, bn.eps))


def _stats(bn):
    return bn.weight, bn.bias, bn.running_mean, bn.running_var


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("n,c", [(1, 16), (3, 13)])
@pytest.mark.parametrize("hw", [3, 6, 12])
@pytest.mark.parametrize("k", [3, 5])
def test_plain_matches_the_stock_sequence(k, hw, n, c, layout):
    # hw 3 and 6 at k5 (halo 4), hw 3 at k3 (halo 2): maps smaller than the halo
    conv, bn = _conv_bn(c, k, seed=k * 100 + hw)
    x = torch.randn(n, c, hw, hw + 1, generator=torch.Generator().manual_seed(hw))
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        p = fold_dw_bn(conv.weight, _stats(bn), bn.eps, torch.float32)
        got = dw_dilated_bn_silu_nhwc_plain(x, p, 2)
        want = _stock(x, conv, bn, 2)
        assert got.shape == want.shape and got.dtype == torch.float32
        assert _rel(got, want) <= 1e-5
        # on the CPU the wrapper is its plain version
        assert torch.equal(dw_dilated_bn_silu_nhwc(x, p, 2), got)


@pytest.mark.parametrize("d", [1, 2, 4])
def test_plain_takes_each_dilation(d):
    conv, bn = _conv_bn(8, 5, seed=d)
    conv.dilation = (d, d)
    x = torch.randn(2, 8, 7, 9, generator=torch.Generator().manual_seed(d))
    with torch.no_grad():
        p = fold_dw_bn(conv.weight, _stats(bn), bn.eps, torch.float32)
        assert _rel(dw_dilated_bn_silu_nhwc(x, p, d), _stock(x, conv, bn, d)) <= 1e-5


def test_bf16_is_one_cast_of_fp32_sums():
    # bf16: the folded weights rounded once, fp32 sums, one cast of the output
    conv, bn = _conv_bn(24, 5, seed=9)
    x = torch.randn(2, 24, 10, 10, generator=torch.Generator().manual_seed(9)).bfloat16()
    with torch.no_grad():
        p = fold_dw_bn(conv.weight, _stats(bn), bn.eps, torch.bfloat16)
        got = dw_dilated_bn_silu_nhwc(x, p, 2)
        wide = dw_dilated_bn_silu_nhwc_plain(x.float(), DwFolded(p.w.float(), p.shift), 2)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, wide.bfloat16())


def _block(k, cin=16, cout=24, seed=3, dilation=2):
    return init_random_weights_(
        MBConvBlock(cin, cout, 6, 1, k, dilation, dtype=torch.float32), seed).eval()


class _Spy:
    """Counts the block's calls of the dilated kernel's wrapper."""

    def __init__(self, monkeypatch):
        self.calls = 0
        wrapper = encoders.dw_dilated_bn_silu_nhwc

        def spy(*args, **kwargs):
            self.calls += 1
            return wrapper(*args, **kwargs)
        monkeypatch.setattr(encoders, "dw_dilated_bn_silu_nhwc", spy)


def _stock_block(blk, x, monkeypatch):
    """The block's output on the stock path: a partitioned run is active."""
    with monkeypatch.context() as m:
        m.setattr(partition, "active", lambda: object())
        return blk(x)


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("k,cin,cout,hw", [(5, 16, 24, 3), (5, 24, 24, 10), (3, 24, 32, 7),
                                           (3, 12, 12, 4)])
def test_eval_dilated_block_takes_the_kernel_and_matches_stock(monkeypatch, k, cin, cout,
                                                               hw, layout):
    blk = _block(k, cin, cout)
    assert blk.residual == (cin == cout)
    x = torch.randn(2, cin, hw, hw + 2, generator=torch.Generator().manual_seed(hw))
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        want = _stock_block(blk, x, monkeypatch)
        spy = _Spy(monkeypatch)
        got = blk(x)
    assert spy.calls == 1
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("case", ["train", "partition", "undilated"])
def test_train_mode_partitions_and_undilated_blocks_keep_the_stock_path(monkeypatch, case):
    blk = _block(5, dilation=1 if case == "undilated" else 2)
    x = torch.randn(2, 16, 6, 6, generator=torch.Generator().manual_seed(1))
    spy = _Spy(monkeypatch)
    with torch.no_grad():
        if case == "train":
            blk.train()(x)
        elif case == "partition":
            _stock_block(blk, x, monkeypatch)
        else:
            blk(x)
    assert spy.calls == 0 and "_dw_folded" not in blk.__dict__


def test_eval_forward_with_grad_raises_before_folding():
    blk = _block(5)
    x = torch.randn(1, 16, 5, 5)
    with pytest.raises(RuntimeError, match="no backward"):
        blk(x)
    assert "_dw_folded" not in blk.__dict__
    with torch.no_grad():
        blk(x)
    assert "_dw_folded" in blk.__dict__


def _folds(blk, x, times):
    profiler.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(times):
            blk(x)
    return profiler.counters().get("kernels.dw_fold", 0)


_EDITS = {
    "load_state_dict": lambda m: m.load_state_dict(
        {k: v + 0.01 if v.is_floating_point() else v for k, v in m.state_dict().items()}),
    "running_mean": lambda m: m._bn1.running_mean.add_(0.25),
    "conv_weight": lambda m: m._depthwise_conv.weight.mul_(1.5),
    "bn_weight": lambda m: m._bn1.weight.mul_(0.5),
}


@pytest.mark.parametrize("edit", sorted(_EDITS))
def test_dw_fold_counts_once_and_again_after_an_edit(edit):
    blk = _block(5, 24, 24)
    x = torch.randn(2, 24, 6, 6, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        before = blk(x)
        assert _folds(blk, x, 2) == 0            # folded by the first forward, kept
        assert blk.dw_fold() is blk.dw_fold()
        _EDITS[edit](blk)
        assert _folds(blk, x, 2) == 1            # folded again once
        after = blk(x)
        fresh = MBConvBlock(24, 24, 6, 1, 5, 2, dtype=torch.float32).eval()
        fresh.load_state_dict(blk.state_dict())
        torch.testing.assert_close(after, fresh(x), atol=0, rtol=0)
        assert not torch.equal(after, before)


def test_dw_fold_counts_on_a_new_dtype():
    blk = _block(3, 24, 24)
    x = torch.randn(1, 24, 5, 5)
    with torch.no_grad():
        assert _folds(blk, x, 2) == 1
        blk.dtype = torch.bfloat16
        assert _folds(blk, x, 2) == 1
        assert blk.dw_fold().w.dtype == torch.bfloat16


def _fused_block():
    return init_random_weights_(
        MBConvBlock(16, 16, 1, 1, 3, fused=True, dtype=torch.float32), 4).eval()


# rank 0 of a model axis of 2: 16 channels split in two
_GRID = types.SimpleNamespace(model=types.SimpleNamespace(rank=0, size=2))


@pytest.mark.parametrize("slot", ["_folded", "_dw_folded"])
def test_sharding_drops_the_folds_of_the_whole_weights(slot):
    blk = _fused_block() if slot == "_folded" else _block(5)
    with torch.no_grad():
        (blk.fold if slot == "_folded" else blk.dw_fold)()
    assert slot in blk.__dict__
    shard_params_tp(blk, _GRID, 16)
    assert slot not in blk.__dict__


def test_a_fold_from_channel_slices_counts_every_call_and_keeps_nothing():
    blk = _fused_block()
    with torch.no_grad():
        want = blk.fold()
    saved = {name: p.detach().clone() for name, p in blk.named_parameters()}
    shard_params_tp(blk, _GRID, 16)
    whole = {id(p): saved[name] for name, p in blk.named_parameters()}
    profiler.clear()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        got = [blk.fold(lambda t: whole[id(t)]) for _ in range(2)]
    assert profiler.counters().get("kernels.k1_fold", 0) == 2
    assert "_folded" not in blk.__dict__ and got[0] is not got[1]
    for field, w in want._asdict().items():
        assert (w is None and got[1]._asdict()[field] is None) or torch.equal(
            got[1]._asdict()[field], w), field


def _valid():
    return (torch.zeros(2, 8, 6, 6), DwFolded(torch.zeros(5, 5, 8), torch.zeros(8)))


_REFUSALS = {
    "float16": (lambda x, p: (x.half(), p._replace(w=p.w.half())), 2, TypeError),
    "float64": (lambda x, p: (x.double(), p._replace(w=p.w.double())), 2, TypeError),
    "weights_dtype": (lambda x, p: (x, p._replace(w=p.w.bfloat16())), 2, TypeError),
    "shift_dtype": (lambda x, p: (x, p._replace(shift=p.shift.bfloat16())), 2, TypeError),
    "3d_input": (lambda x, p: (x[0], p), 2, ValueError),
    "k7": (lambda x, p: (x, DwFolded(torch.zeros(7, 7, 8), p.shift)), 2, ValueError),
    "k4": (lambda x, p: (x, DwFolded(torch.zeros(4, 4, 8), p.shift)), 2, ValueError),
    "channels": (lambda x, p: (x[:, :6], p), 2, ValueError),
    "shift_shape": (lambda x, p: (x, p._replace(shift=torch.zeros(6))), 2, ValueError),
    "dilation_0": (lambda x, p: (x, p), 0, ValueError),
    "dilation_5": (lambda x, p: (x, p), 5, ValueError),
    "dilation_float": (lambda x, p: (x, p), 2.0, ValueError),
    "empty": (lambda x, p: (x[:, :, :0], p), 2, ValueError),
    "batch_past_the_grid": (lambda x, p: (torch.zeros(65536, 8, 1, 1), p), 2, ValueError),
    "meta_device": (lambda x, p: (x.to("meta"), p), 2, ValueError),
}


@pytest.mark.parametrize("case", sorted(_REFUSALS))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    make, dilation, error = _REFUSALS[case]
    x, p = make(*_valid())
    before = dict(depthwise.LAUNCHES)
    with pytest.raises(error):
        dw_dilated_bn_silu_nhwc(x, p, dilation)
    assert depthwise.LAUNCHES == before


@pytest.mark.parametrize("tta,forwards", [(True, 3), (False, 1)])
def test_a_tiled_request_runs_each_dilated_block_once_a_forward(monkeypatch, tta, forwards):
    # the tiny flagship's DeepLab encoder (output stride 16) has one dilated
    # block in each of stages 5 and 6; a tiled request with TTA runs three
    # forwards (the trio, and each scale), without TTA one
    import numpy as np

    from enhanced_unet_tpu_torch.models import get_model
    from enhanced_unet_tpu_torch.train.evaluator import Evaluator

    model = get_model("enhanced_unet", dtype=torch.float32, device="cpu", seed=3,
                      encoder_names=("efficientnet-tiny", "efficientnet-tiny"))
    dilated = [m for m in model.modules() if isinstance(m, MBConvBlock) and m.dilation > 1]
    assert len(dilated) == 2 and all(m in set(model.deeplab.modules()) for m in dilated)
    ev = Evaluator(model, "enhanced_unet", enable_tta=tta, device="cpu", verbose=False,
                   tiled=True, tile=64, overlap=16)
    spy = _Spy(monkeypatch)
    ev.predict_semantic_masks_tiled(
        np.random.default_rng(5).random((1, 96, 128, 3)).astype(np.float32))
    assert spy.calls == forwards * len(dilated)
