"""K2's packed weights (`pack_conv3x3`, `fused_conv3x3_bn_relu_packed`) and
the ConvBNAct cache that keeps them, on the CPU.

- The packed entry (BN folded, cast and permuted once) against the JAX
  `fused_conv3x3_bn_relu_reference` with the JAX `fold_bn_params`, fp32,
  1e-4 as in tests/test_pallas_kernels.py.
- The small-Cin kernel's packed K, multiplied out here as the kernel
  multiplies it, against the plain conv: a wrong K order or padding shows
  on the CPU, not only on the card.
- The shape rule that picks each kernel: every shape the flagship's serving
  path gives K2 reaches the wgmma or the small-Cin kernel.
- ConvBNAct packs once and packs again after `load_state_dict`, an in-place
  weight edit or a BatchNorm statistic change, giving the new answer.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from enhanced_unet_tpu.ops.pallas import conv_fused as jconv
from enhanced_unet_tpu_torch.models import blocks, init_random_weights_
from enhanced_unet_tpu_torch.ops.kernels import conv_fused

torch.set_num_threads(1)

# (Cin, Cout) of the 22 distinct 3x3 ConvBNAct calls of one flagship
# forward (B5 UNet++ and B4 DeepLabV3+ decoders, fusion head)
SERVING_CHANNELS = [(688, 256), (256, 256), (240, 64), (64, 64), (104, 40), (40, 40),
                    (88, 48), (48, 48), (384, 128), (128, 128), (144, 40), (136, 48),
                    (248, 64), (184, 48), (256, 32), (32, 32), (32, 16), (16, 16),
                    (6, 256), (256, 128), (128, 64)]


def _bn_arrays(rng, cout):
    return ((rng.normal(size=(cout,)) * 0.3 + 1.0).astype(np.float32),   # gamma
            (rng.normal(size=(cout,)) * 0.1).astype(np.float32),         # beta
            (rng.normal(size=(cout,)) * 0.2).astype(np.float32),         # mean
            (rng.random(cout) + 0.5).astype(np.float32))                 # var


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("cout", [5, 16, 48])
@pytest.mark.parametrize("cin", [6, 70, 128])
def test_packed_matches_jax_reference(rng, cin, cout, relu, bias):
    x = rng.normal(size=(2, 7, 9, cin)).astype(np.float32)
    w = (rng.normal(size=(3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    bn = _bn_arrays(rng, cout)
    b = (rng.normal(size=(cout,)) * 0.1).astype(np.float32) if bias else None
    t = torch.from_numpy
    scale, shift = conv_fused.fold_bn_params(*map(t, bn), 1e-5,
                                             conv_bias=None if b is None else t(b))
    packed = conv_fused.pack_conv3x3(t(w), scale, shift, torch.float32, "cpu")
    got = conv_fused.fused_conv3x3_bn_relu_packed(t(x), packed, relu)
    jscale, jshift = jconv.fold_bn_params(*map(jnp.asarray, bn), 1e-5,
                                          conv_bias=None if b is None else jnp.asarray(b))
    ref = jconv.fused_conv3x3_bn_relu_reference(jnp.asarray(x), jnp.asarray(w), jscale,
                                                jshift, relu=relu)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("cin,cout", [(1, 8), (3, 64), (6, 256), (7, 72)])
def test_smallc_packed_k_reproduces_the_conv(rng, cin, cout):
    x = torch.from_numpy(rng.normal(size=(2, 6, 11, cin)).astype(np.float32)).bfloat16()
    w = torch.from_numpy((rng.normal(size=(3, 3, cin, cout)) * 0.2).astype(np.float32))
    ones, zeros = torch.ones(cout), torch.zeros(cout)
    packed = conv_fused.pack_conv3x3(w, ones, zeros, torch.bfloat16, "cpu")
    assert packed.variant == "smallc"
    assert packed.wk.shape == (-(-cout // 64) * 64, conv_fused.SMALLC_K)
    # the kernel's patch: k = (3*dy + dx) * Cin + ci, zero past 9 * Cin
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    taps = [xp[:, dy:dy + 6, dx:dx + 11, :] for dy in range(3) for dx in range(3)]
    patch = F.pad(torch.cat(taps, dim=-1), (0, conv_fused.SMALLC_K - 9 * cin))
    got = (patch @ packed.wk.float().T)[..., :cout]
    want = conv_fused.fused_conv3x3_bn_relu_plain(x.float(), w.bfloat16().float(), ones,
                                                  zeros, relu=False)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert not packed.wk[cout:].any() and not packed.wk[:, 9 * cin:].any()


def test_every_serving_shape_reaches_wgmma_or_smallc():
    variant = conv_fused.variant_for
    for cin, cout in SERVING_CHANNELS:
        assert variant(cin, cout, torch.bfloat16) == (
            "smallc" if cin <= conv_fused.SMALLC_MAX_CIN else "wgmma"), (cin, cout)
    assert variant(70, 5, torch.bfloat16) == "mma"        # Cin and Cout ragged
    assert variant(64, 5, torch.bfloat16) == "mma"        # Cout ragged
    assert variant(6, 5, torch.bfloat16) == "mma"
    assert variant(12, 16, torch.bfloat16) == "mma"       # above the packed K
    assert variant(8, 16, torch.bfloat16) == "wgmma"
    assert variant(6, 256, torch.float32) == "f32"


def test_packed_entry_refuses_other_devices():
    packed = conv_fused.pack_conv3x3(torch.zeros(3, 3, 4, 8), torch.ones(8),
                                     torch.zeros(8), torch.float32, "cpu")
    with pytest.raises(ValueError, match="device"):
        conv_fused.fused_conv3x3_bn_relu_packed(
            torch.empty(1, 8, 8, 4, device="meta"), packed)


def _edit_load_state_dict(m):
    other = init_random_weights_(blocks.ConvBNAct(8, 16, dtype=torch.float32), 9)
    m.load_state_dict(other.state_dict())


_EDITS = {
    "load_state_dict": _edit_load_state_dict,
    "weight_mul_": lambda m: m[0].weight.mul_(1.5),
    "running_mean": lambda m: m[1].running_mean.add_(0.25),
    "running_var": lambda m: m[1].running_var.mul_(2.0),
    "bn_weight": lambda m: m[1].weight.mul_(-1.0),
}


@pytest.mark.parametrize("edit", sorted(_EDITS))
def test_conv_bn_act_cache_packs_again_after_an_edit(monkeypatch, rng, edit):
    packs = []
    pack = blocks.pack_conv3x3
    monkeypatch.setattr(blocks, "pack_conv3x3", lambda *a: packs.append(1) or pack(*a))
    m = init_random_weights_(blocks.ConvBNAct(8, 16, dtype=torch.float32), 3).eval()
    x = torch.from_numpy(rng.normal(size=(2, 8, 9, 11)).astype(np.float32))

    def fresh():   # a module that never ran, on the same state
        ref = blocks.ConvBNAct(8, 16, dtype=torch.float32).eval()
        ref.load_state_dict(m.state_dict())
        return ref(x)

    with torch.no_grad():
        before = m(x)
        assert torch.equal(m(x), before) and len(packs) == 1     # packed once
        _EDITS[edit](m)
        after = m(x)
        assert len(packs) == 2                                    # packed again
        torch.testing.assert_close(after, fresh(), atol=0, rtol=0)
        assert not torch.equal(after, before)
        m(x)
    assert len(packs) == 3     # `fresh` packs its own module once; `m` keeps its pack
