"""The fused MBConv at the serving path's shapes (`variant_for` "nhwc": bf16,
no expand, mid = Cin and Cout multiples of 8 up to 64), on the CPU.

On the CPU the wrapper runs its plain version, the plain version of both
kernel variants; these tests hold it, through the port's `MBConvBlock` on a
channels_last input, against the JAX package at the serving channel counts
(48 -> 24, and 24 -> 24 with a residual):

- the flax `MBConvBlock` stock path (fp32: 1e-4 of the reference's max
  |value|; bf16: 3e-2, as in tests/test_pallas_mbconv.py);
- the Pallas `mbconv_infer_nchw` in interpret mode (bf16, 3e-2).

Also: which variant each shape reaches, that the memory format does not
change the values, and that `MBConvBlock` folds its weights once and again
after `load_state_dict`, `.to()` or an in-place edit of a BN statistic.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from enhanced_unet_tpu_torch.models import encoders, init_random_weights_
from enhanced_unet_tpu_torch.models.encoders import MBConvBlock
from enhanced_unet_tpu_torch.ops.kernels import mbconv
from test_torch_port_kernels import _block_pair, _jax_block_vars, _rel_err

torch.set_num_threads(1)

# (cin, cout, residual) of the fused stage-0 blocks of B5 and B4
SERVING_BLOCKS = [(48, 24, False), (24, 24, True)]


def _block(cin, cout, ratio=1, dtype=torch.bfloat16, seed=3):
    return init_random_weights_(
        MBConvBlock(cin, cout, ratio, 1, 3, fused=True, dtype=dtype), seed).eval()


def _channels_last(rng, n, c, h, w):
    x = (rng.normal(size=(n, h, w, c)) * 0.5).astype(np.float32)
    return x, torch.from_numpy(x).permute(0, 3, 1, 2)   # NHWC memory, NCHW shape


@pytest.mark.parametrize("n", [1, 6])
@pytest.mark.parametrize("cin,cout,residual", SERVING_BLOCKS)
def test_serving_blocks_reach_nhwc(n, cin, cout, residual):
    blk = _block(cin, cout)
    assert blk.residual == residual
    x = torch.empty(n, cin, 8, 8, dtype=torch.bfloat16)
    assert mbconv.variant_for(x, blk.fold()) == "nhwc"


@pytest.mark.parametrize("case", ["expand6", "fp32", "c20", "cout72"])
def test_other_blocks_reach_nchw(case):
    # expand6: stage 3's width (Cin 128), past the nhwc_expand kernels' 64
    cin, cout, ratio, dtype = {"expand6": (128, 128, 6, torch.bfloat16),
                               "fp32": (24, 24, 1, torch.float32),
                               "c20": (20, 24, 1, torch.bfloat16),
                               "cout72": (24, 72, 1, torch.bfloat16)}[case]
    blk = _block(cin, cout, ratio, dtype)
    x = torch.empty(2, cin, 8, 8, dtype=dtype)
    assert mbconv.variant_for(x, blk.fold()) == "nchw"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,residual", SERVING_BLOCKS)
def test_block_matches_flax_block(rng, dtype, cin, cout, residual):
    port, ref = _block_pair(cin, cout, 1, dtype, 7)
    x, xt = _channels_last(rng, 2, cin, 16, 24)
    with torch.no_grad():
        got = port(xt)
    want = np.asarray(ref.apply(_jax_block_vars(port), jnp.asarray(x), False), np.float32)
    assert got.dtype == dtype and got.shape == (2, cout, 16, 24)
    got = got.float().permute(0, 2, 3, 1).numpy()
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("cin,cout,residual", SERVING_BLOCKS)
def test_block_matches_pallas_interpret(rng, cin, cout, residual):
    from enhanced_unet_tpu.ops.pallas.mbconv import fold_mbconv_weights, mbconv_infer_nchw

    port, _ = _block_pair(cin, cout, 1, torch.bfloat16, 9)
    v = _jax_block_vars(port)
    P, S = v["params"], v["batch_stats"]

    def bn(i):
        return {k: jnp.asarray(a) for k, a in {**P[f"BatchNorm_{i}"],
                                                **S[f"BatchNorm_{i}"]}.items()}

    def conv(i):
        return {k: jnp.asarray(a) for k, a in P[f"Conv_{i}"].items()}

    w = {"expand": None, "bn0": None, "dw": conv(0)["kernel"], "bn1": bn(0),
         "se1": conv(1), "se2": conv(2), "project": conv(3)["kernel"], "bn2": bn(1)}
    x, xt = _channels_last(rng, 2, cin, 16, 16)
    want = mbconv_infer_nchw(jnp.asarray(np.transpose(x, (0, 3, 1, 2)), jnp.bfloat16),
                             fold_mbconv_weights(w, 16, 16), residual=residual)
    with torch.no_grad():
        got = port(xt)
    assert _rel_err(got.float(), np.asarray(want, np.float32)) < 3e-2


@pytest.mark.parametrize("cin,cout,residual", SERVING_BLOCKS)
def test_memory_format_does_not_change_the_values(rng, cin, cout, residual):
    blk = _block(cin, cout)
    _, xt = _channels_last(rng, 2, cin, 12, 20)
    assert xt.is_contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        a = blk(xt)
        b = blk(xt.contiguous())
    assert a.shape == b.shape == (2, cout, 12, 20)
    assert torch.equal(a, b)


# (n, h, w, slots16, slots8, rows): the serving shapes on an H100 (132 SMs;
# 2 blocks per SM at C = 48, 4 at C = 24), then a grid of one tile
@pytest.mark.parametrize("n,h,w,slots16,slots8,rows", [
    (6, 256, 256, 264, 264, 16),    # 3 waves of 16 rows = 6 of 8
    (6, 256, 256, 528, 528, 8),     # 2 waves of 16 rows, 3 of 8
    (2, 192, 192, 264, 264, 16),    # 1 wave of 16 rows = 2 of 8
    (2, 192, 192, 528, 528, 8),     # 1 wave either way
    (2, 320, 320, 264, 264, 16),
    (2, 320, 320, 528, 528, 16),
    (1, 8, 8, 132, 132, 8),
])
def test_nhwc_tile_rows(n, h, w, slots16, slots8, rows):
    assert mbconv.nhwc_tile_rows(n, h, w, slots16, slots8) == rows


def test_nhwc_entry_points_refuse_a_cpu_tensor():
    blk = _block(24, 24)
    x = torch.zeros(1, 24, 8, 8, dtype=torch.bfloat16)
    p = blk.fold()
    before = dict(mbconv.LAUNCHES)
    with pytest.raises(ValueError, match="device"):
        mbconv.mbconv_nhwc_pass1(x, p)
    with pytest.raises(ValueError, match="device"):
        mbconv.mbconv_nhwc_pass2(x, p, torch.zeros(1, 24, 24, dtype=torch.bfloat16), True)
    assert mbconv.LAUNCHES == before


def _edit_load_state_dict(m):
    m.load_state_dict(_block(48, 24, seed=11).state_dict())


_EDITS = {
    "load_state_dict": _edit_load_state_dict,
    "to_float64": lambda m: m.to(torch.float64),
    "running_mean": lambda m: m._bn1.running_mean.add_(0.25),
    "running_var": lambda m: m._bn2.running_var.mul_(2.0),
}


@pytest.mark.parametrize("edit", sorted(_EDITS))
def test_fold_is_kept_and_redone_after_an_edit(monkeypatch, rng, edit):
    folds = []
    fold = encoders.fold_mbconv_weights
    monkeypatch.setattr(encoders, "fold_mbconv_weights",
                        lambda *a, **k: folds.append(1) or fold(*a, **k))
    m = _block(48, 24, dtype=torch.float32)
    _, x = _channels_last(rng, 2, 48, 9, 11)

    def fresh():   # a module that never ran, on the same state
        ref = MBConvBlock(48, 24, 1, 1, 3, fused=True, dtype=torch.float32).eval()
        ref.to(m._bn1.running_mean.dtype).load_state_dict(m.state_dict())
        return ref(x)

    with torch.no_grad():
        before = m(x)
        assert m.fold() is m.fold()
        assert torch.equal(m(x), before) and len(folds) == 1     # folded once
        _EDITS[edit](m)
        after = m(x)
        assert len(folds) == 2                                    # folded again
        torch.testing.assert_close(after, fresh(), atol=0, rtol=0)
        if edit != "to_float64":      # the same values in wider parameters
            assert not torch.equal(after, before)
        m(x)
    assert len(folds) == 3     # `fresh` folds its own module once; `m` keeps its fold
