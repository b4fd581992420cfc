"""Plain versions of the port's CUDA kernels vs the JAX package.

On the CPU each kernel wrapper runs its plain PyTorch version; these tests
hold it against the JAX references:

- conv3x3+BN+ReLU vs `fused_conv3x3_bn_relu_reference` (fp32, 1e-4 as in
  tests/test_pallas_kernels.py), and vs the Pallas kernel in interpret mode
  (slow lane);
- fused MBConv vs the JAX `MBConvBlock` stock path (fp32: 1e-4 of the
  reference's max |value|; bf16: 3e-2 relative, as in
  tests/test_pallas_mbconv.py) and vs `mbconv_infer_nchw` in interpret mode
  (slow lane, bf16, 3e-2 relative).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from enhanced_unet_tpu.models.encoders import MBConvBlock as JMBConv
from enhanced_unet_tpu.ops.pallas import conv_fused as jconv
from enhanced_unet_tpu_torch.models import init_random_weights_
from enhanced_unet_tpu_torch.models.encoders import MBConvBlock
from enhanced_unet_tpu_torch.ops.kernels import conv_fused, mbconv

torch.set_num_threads(1)


def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) + 1e-6)


def _conv_inputs(rng, n, h, w, cin, cout):
    return (rng.normal(size=(n, h, w, cin)).astype(np.float32),
            (rng.normal(size=(3, 3, cin, cout)) * 0.1).astype(np.float32),
            (rng.normal(size=(cout,)) * 0.5 + 1.0).astype(np.float32),
            (rng.normal(size=(cout,)) * 0.1).astype(np.float32))


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("cin,cout", [(8, 16), (6, 5)])
def test_conv3x3_plain_matches_reference(rng, relu, cin, cout):
    arrays = _conv_inputs(rng, 2, 9, 13, cin, cout)
    got = conv_fused.fused_conv3x3_bn_relu(*map(torch.from_numpy, arrays),
                                           relu=relu)
    ref = jconv.fused_conv3x3_bn_relu_reference(*map(jnp.asarray, arrays),
                                                relu=relu)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    if not relu:
        assert (got.numpy() < 0).any()


def test_conv3x3_plain_bf16_rounds_like_reference(rng):
    arrays = _conv_inputs(rng, 1, 8, 8, 8, 8)
    x = torch.from_numpy(arrays[0]).bfloat16()
    got = conv_fused.fused_conv3x3_bn_relu(x, *map(torch.from_numpy, arrays[1:]))
    ref = jconv.fused_conv3x3_bn_relu_reference(
        jnp.asarray(arrays[0], jnp.bfloat16), *map(jnp.asarray, arrays[1:]))
    assert got.dtype == torch.bfloat16
    assert _rel_err(got.float(), np.asarray(ref, np.float32)) < 1e-2


@pytest.mark.slow
def test_conv3x3_plain_matches_pallas_interpret(rng):
    arrays = _conv_inputs(rng, 2, 16, 128, 8, 16)
    got = conv_fused.fused_conv3x3_bn_relu(*map(torch.from_numpy, arrays))
    ref = jconv.fused_conv3x3_bn_relu(*map(jnp.asarray, arrays), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_fold_bn_params(rng):
    g, b, m, b2 = (rng.normal(size=(8,)).astype(np.float32) for _ in range(4))
    v = (rng.random(8) + 0.5).astype(np.float32)
    ours = conv_fused.fold_bn_params(*map(torch.from_numpy, (g, b, m, v)),
                                     1e-5, conv_bias=torch.from_numpy(b2))
    ref = jconv.fold_bn_params(*map(jnp.asarray, (g, b, m, v)), 1e-5,
                               conv_bias=jnp.asarray(b2))
    for a, r in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-6, atol=1e-7)


def _hwio(t):
    return np.transpose(t.detach().numpy(), (2, 3, 1, 0))


def _jax_block_vars(block: MBConvBlock):
    """The port block's weights as the flax MBConvBlock variable tree."""
    def bn(m):
        return ({"scale": m.weight.detach().numpy(), "bias": m.bias.detach().numpy()},
                {"mean": m.running_mean.numpy(), "var": m.running_var.numpy()})

    convs, bns = [], []
    if block.expand_ratio != 1:
        convs.append({"kernel": _hwio(block._expand_conv.weight)})
        bns.append(bn(block._bn0))
    convs.append({"kernel": _hwio(block._depthwise_conv.weight)})
    bns.append(bn(block._bn1))
    for se in (block._se_reduce, block._se_expand):
        convs.append({"kernel": _hwio(se.weight), "bias": se.bias.detach().numpy()})
    convs.append({"kernel": _hwio(block._project_conv.weight)})
    bns.append(bn(block._bn2))
    params = {f"Conv_{i}": c for i, c in enumerate(convs)}
    params.update({f"BatchNorm_{i}": b[0] for i, b in enumerate(bns)})
    stats = {f"BatchNorm_{i}": b[1] for i, b in enumerate(bns)}
    return {"params": params, "batch_stats": stats}


def _block_pair(cin, cout, ratio, dtype, seed):
    port = MBConvBlock(cin, cout, ratio, 1, 3, fused=True, dtype=dtype)
    init_random_weights_(port, seed).eval()
    ref = JMBConv(cin, cout, ratio, (1, 1), 3,
                  dtype=jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
    return port, ref


@pytest.mark.parametrize("ratio", [1, 6])
@pytest.mark.parametrize("cin,cout", [(8, 8), (8, 16)])
def test_mbconv_plain_matches_jax_block_fp32(rng, ratio, cin, cout):
    port, ref = _block_pair(cin, cout, ratio, torch.float32, 7)
    x = (rng.normal(size=(2, 12, 17, cin)) * 0.5).astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(np.transpose(x, (0, 3, 1, 2)).copy()))
    want = ref.apply(_jax_block_vars(port), jnp.asarray(x), False)
    got = got.permute(0, 2, 3, 1).numpy()
    assert np.abs(got - np.asarray(want)).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("ratio", [1, 6])
def test_mbconv_plain_matches_jax_block_bf16(rng, ratio):
    port, ref = _block_pair(8, 8, ratio, torch.bfloat16, 8)
    x = (rng.normal(size=(2, 16, 16, 8)) * 0.5).astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(np.transpose(x, (0, 3, 1, 2)).copy()))
    want = ref.apply(_jax_block_vars(port), jnp.asarray(x), False)
    assert got.dtype == torch.bfloat16
    assert _rel_err(got.float().permute(0, 2, 3, 1), want) < 3e-2


@pytest.mark.slow
@pytest.mark.parametrize("ratio,residual", [(1, True), (6, False)])
def test_mbconv_plain_matches_pallas_interpret(rng, ratio, residual):
    from enhanced_unet_tpu.ops.pallas.mbconv import (
        fold_mbconv_weights,
        mbconv_infer_nchw,
    )

    cout = 8 if residual else 16
    port, _ = _block_pair(8, cout, ratio, torch.bfloat16, 9)
    v = _jax_block_vars(port)
    P, S = v["params"], v["batch_stats"]

    def bn(i):
        return {**P[f"BatchNorm_{i}"], **S[f"BatchNorm_{i}"]}

    if ratio != 1:
        w = {"expand": P["Conv_0"]["kernel"], "bn0": bn(0), "dw": P["Conv_1"]["kernel"],
             "bn1": bn(1), "se1": P["Conv_2"], "se2": P["Conv_3"],
             "project": P["Conv_4"]["kernel"], "bn2": bn(2)}
    else:
        w = {"expand": None, "bn0": None, "dw": P["Conv_0"]["kernel"], "bn1": bn(0),
             "se1": P["Conv_1"], "se2": P["Conv_2"], "project": P["Conv_3"]["kernel"],
             "bn2": bn(1)}
    w = {k: (None if val is None else
             {kk: jnp.asarray(vv) for kk, vv in val.items()} if isinstance(val, dict)
             else jnp.asarray(val)) for k, val in w.items()}
    x = (rng.normal(size=(2, 8, 16, 16)) * 0.5).astype(np.float32)
    want = mbconv_infer_nchw(jnp.asarray(x, jnp.bfloat16),
                             fold_mbconv_weights(w, 16, 16), residual=residual)
    with torch.no_grad():
        got = mbconv.mbconv_infer_nchw(torch.from_numpy(x).bfloat16(),
                                       port.fold(), residual=residual)
    assert _rel_err(got.float(), np.asarray(want, np.float32)) < 3e-2
