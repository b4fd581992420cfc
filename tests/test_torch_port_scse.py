"""The UNet++ decoder's scSE over a list of channel parts
(`ops/kernels/scse.py`), on the CPU: the plain version against the stock
sequence it replaces (nearest upsample, `torch.cat`, `SCSEBlock`'s stock
calls), the routing in `SCSEBlock` and `NestedBlock`, the decoder's parts
lists, the fold cache, the launch plan and what the kernel refuses.  No
JAX: the NestedBlock, decoder and smp parity tests against the JAX package
live in their own files.

Tolerances: fp32 within 1e-5 of max |value| (the upsampled part's mean is
summed over its source, a different fp32 order); bf16 within 2^-7 of it
(that fp32 difference can move the mean's bf16 rounding by one unit, which
moves a channel gate by at most one bf16 unit, 2^-8 of the largest value).
"""

import collections

import pytest
import torch

import card_cases
from enhanced_unet_tpu_torch.models import init_random_weights_
from enhanced_unet_tpu_torch.models.blocks import SCSEBlock
from enhanced_unet_tpu_torch.models.enhanced_unet import NestedBlock, UnetPlusPlusDecoder
from enhanced_unet_tpu_torch.ops import partition
from enhanced_unet_tpu_torch.ops.kernels import scse
from enhanced_unet_tpu_torch.ops.resize import upsample2x_nearest_nchw
from enhanced_unet_tpu_torch.utils import profiler

torch.set_num_threads(1)
B5_CHANNELS = (3, 48, 40, 64, 176, 512)


def _tol(dtype):
    return 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5


def _rel(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def _parts(widths, up, hw, n=2, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(n, c, hw // 2 if up and i == 0 else hw, hw // 2 if up and i == 0 else hw,
                        generator=g).to(dtype) for i, c in enumerate(widths)]


def _block(c, dtype, seed=3):
    return init_random_weights_(SCSEBlock(c, dtype=dtype), seed)


def _stock(block, parts, up):
    x = torch.cat([upsample2x_nearest_nchw(parts[0]) if up else parts[0], *parts[1:]], dim=1)
    with torch.no_grad():
        return block.train()(x)


# each node's parts: x_0_0 (the node below upsampled 16^2 -> 32^2 and the
# encoder feature), x_0_3 (five parts, at 32^2 for the CPU), x_0_4's
# attention2 (one part), and the 384^2 and 640^2 tiles' maps of x_0_0
# (12^2 -> 24^2, 20^2 -> 40^2)
_LAYOUTS = {
    "x_0_0": ((512, 176), True, 32),
    "x_0_3": ((64, 48, 48, 48, 48), True, 32),
    "x_0_4": ((16,), False, 64),
    "x_0_0_384": ((512, 176), True, 24),
    "x_0_0_640": ((512, 176), True, 40),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("node", sorted(_LAYOUTS))
def test_plain_parts_match_the_stock_sequence(dtype, node):
    widths, up, hw = _LAYOUTS[node]
    parts = _parts(widths, up, hw, dtype=dtype, seed=hw + len(widths))
    block = _block(sum(widths), dtype)
    want = _stock(block, parts, up)
    got = scse.scse_parts_plain(parts, up, block.fold())
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    assert _rel(got, want) <= _tol(dtype)
    with torch.no_grad():
        routed = block.eval()(*parts, up=up)
    assert torch.equal(routed, got)


def test_eval_mode_routes_through_scse_parts_and_train_mode_does_not(monkeypatch):
    calls = []
    plain = scse.scse_parts

    def recording(parts, up, w):
        calls.append((tuple(t.shape[1] for t in parts), up))
        return plain(parts, up, w)

    monkeypatch.setattr("enhanced_unet_tpu_torch.models.blocks.scse_parts", recording)
    parts = _parts((24, 8), True, 8)
    block = _block(32, torch.float32)
    with torch.no_grad():
        block.eval()(*parts, up=True)
        block.train()(torch.cat([upsample2x_nearest_nchw(parts[0]), parts[1]], dim=1))
    assert calls == [((24, 8), True)]


def test_a_partitioned_run_takes_the_stock_sequence(monkeypatch):
    # spatial partitioning and tensor parallelism see PyTorch calls only:
    # with a partition active the block concatenates and runs its stock calls
    parts = _parts((24, 8), True, 8)
    block = _block(32, torch.float32).eval()
    called = []
    monkeypatch.setattr("enhanced_unet_tpu_torch.models.blocks.scse_parts",
                        lambda *a: called.append(a))
    monkeypatch.setattr(partition, "active", lambda: object())
    with torch.no_grad():
        got = block(*parts, up=True)
    assert not called
    assert torch.equal(got, _stock(block, parts, True))


def test_an_eval_forward_with_grad_raises():
    block = _block(16, torch.float32).eval()
    with pytest.raises(RuntimeError, match="no backward"):
        block(torch.randn(1, 16, 4, 4))
    with torch.no_grad():
        block(torch.randn(1, 16, 4, 4))


def test_nested_block_splits_its_skips_freely():
    node = init_random_weights_(NestedBlock(16, 24, 8, dtype=torch.float32), 5).eval()
    x, a, b = _parts((16, 16, 8), True, 8, n=1, seed=9)
    with torch.no_grad():
        one = node(x, [torch.cat([a, b], dim=1)])
        listed = node(x, [a, b])
    assert torch.allclose(one, listed, rtol=0, atol=1e-6 * one.abs().max().item())


def test_the_decoder_hands_each_node_its_parts(monkeypatch):
    # the B5 flagship's decoder at a 64^2 tile: the 21 calls of a forward,
    # with the parts, upsample flags and strides of `card_cases.SCSE_CALLS`
    calls = []
    plain = scse.scse_parts

    def recording(parts, up, w):
        calls.append((tuple(t.shape[1] for t in parts), up, 64 // parts[-1].shape[2]))
        return plain(parts, up, w)

    monkeypatch.setattr("enhanced_unet_tpu_torch.models.blocks.scse_parts", recording)
    decoder = init_random_weights_(
        UnetPlusPlusDecoder(B5_CHANNELS, (256, 128, 64, 32, 16), torch.float32), 1).eval()
    g = torch.Generator().manual_seed(0)
    features = [torch.randn(1, c, 64 >> i, 64 >> i, generator=g)
                for i, c in enumerate(B5_CHANNELS)]
    with torch.no_grad():
        out = decoder(*features)
    assert out.shape == (1, 16, 64, 64)
    assert collections.Counter(calls) == collections.Counter(card_cases.SCSE_CALLS)
    assert card_cases.SCSE_A_REQUEST == 63


def test_the_fold_is_kept_until_a_weight_changes():
    block = _block(32, torch.bfloat16).eval()
    x = torch.randn(1, 32, 4, 4).to(torch.bfloat16)
    profiler.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]), \
            torch.no_grad():
        block(x)
        block(x)
        first = profiler.counters().get("kernels.scse_fold", 0)
        block.sSE[0].weight.mul_(2.0)
        block(x)
    assert first == 1
    assert profiler.counters()["kernels.scse_fold"] == 2
    w = block.fold()
    assert w.ws.dtype == torch.bfloat16 and w.ws.shape == (32,) and w.w1.shape == (2, 32)
    assert torch.equal(w.ws, (block.sSE[0].weight.reshape(32) * 1).to(torch.bfloat16))


@pytest.mark.parametrize("n,tile", card_cases.MIXFFN_FORWARDS)
def test_the_plan_covers_every_serving_call(n, tile):
    for widths, up, stride in card_cases.SCSE_CALLS:
        hw = tile // stride
        pl = scse.plan(n, hw, hw, widths)
        v = sum(widths) // 8
        assert pl.rows % 2 == 0 and pl.chunks == -(-hw // pl.rows)
        assert pl.group in (1, 2, 4, 8, 16, 32) and 1 <= pl.vectors <= 4
        assert pl.group * pl.vectors >= v > pl.group * (pl.vectors - 1) or pl.group == 32
        assert pl.pixels % (256 // pl.group) == 0
        # the sums pass, and the apply pass where the map allows, fill the card
        assert n * len(widths) * pl.chunks >= 4 * 132 or pl.rows == 2
        assert n * -(-(hw * hw) // pl.pixels) >= 4 * 132 or pl.pixels <= 512


@pytest.mark.parametrize("v,group,vectors", [(2, 1, 2), (4, 1, 4), (5, 2, 3), (6, 2, 3),
                                             (11, 4, 3), (23, 8, 3), (32, 8, 4),
                                             (86, 32, 3), (128, 32, 4)])
def test_the_plan_leaves_few_lanes_idle(v, group, vectors):
    pl = scse.plan(75, 64, 64, [8 * v])
    assert (pl.group, pl.vectors) == (group, vectors)


def _weights(c, dtype=torch.bfloat16):
    return _block(c, dtype).fold()


def test_what_both_versions_refuse():
    w = _weights(32, torch.float32)
    x = torch.randn(1, 16, 4, 4)
    with pytest.raises(ValueError, match="at least one part"):
        scse.scse_parts([], False, w)
    with pytest.raises(ValueError, match="after the first"):
        scse.scse_parts([x, torch.randn(1, 16, 4, 4)], True, w)
    with pytest.raises(ValueError, match="weights for 24 channels"):
        scse.scse_parts([x, torch.randn(1, 8, 8, 8)], True, w)
    with pytest.raises(ValueError, match="one dtype"):
        scse.scse_parts([x, torch.randn(1, 16, 8, 8).double()], True, w)


def _channels_last(t):
    return t.contiguous(memory_format=torch.channels_last)


def test_what_the_kernel_refuses():
    # checked on CPU tensors: the same checks refuse CUDA tensors
    w = _weights(32)
    good = [_channels_last(torch.randn(2, 16, 4, 4).bfloat16()),
            _channels_last(torch.randn(2, 16, 8, 8).bfloat16())]
    assert scse._kernel_refusal(good, True, w) is None
    fp32 = [t.float() for t in good]
    assert scse._kernel_refusal(fp32, True, _weights(32, torch.float32)) is None
    assert "bf16 or fp32" in scse._kernel_refusal(fp32, True, w)      # bf16 weights
    fp16 = [t.half() for t in good]
    assert "bf16 or fp32" in scse._kernel_refusal(fp16, True, _weights(32, torch.float16))
    nchw = [good[0], good[1].contiguous()]
    assert "channels_last" in scse._kernel_refusal(nchw, True, w)
    flat = torch.empty(2 * 8 * 8 * 16 + 3, dtype=torch.bfloat16)
    shifted = flat[3:].view(2, 8, 8, 16).permute(0, 3, 1, 2)
    assert "aligned" in scse._kernel_refusal([good[0], shifted], True, w)
    odd = [_channels_last(torch.randn(2, 12, 4, 4).bfloat16()),
           _channels_last(torch.randn(2, 20, 8, 8).bfloat16())]
    assert "multiple of 8" in scse._kernel_refusal(odd, True, w)
    wide = [_channels_last(torch.randn(1, 520, 2, 2).bfloat16())] * 2
    assert "multiple of 8" in scse._kernel_refusal(wide, False, _weights(1040))
    nine = [_channels_last(torch.randn(1, 8, 2, 2).bfloat16())] * 9
    assert "1 to 8 parts" in scse._kernel_refusal(nine, False, _weights(72))
    # the plain version takes any number of parts
    assert scse.scse_parts([t.float() for t in nine], False, _weights(72, torch.float32)).shape \
        == (1, 72, 2, 2)
