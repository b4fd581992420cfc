"""PyTorch port vs JAX package: flagship building blocks and resizes.

Each port module gets seeded random weights and BatchNorm statistics; the
flax module runs on the same weights through the JAX package's own
converter helpers.  Inputs come from numpy with a seed.  fp32 on the CPU;
tolerance: max |diff| <= 1e-4 of the reference's max |value| (fp32
summation-order noise only).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import linen as fnn

from enhanced_unet_tpu.convert.torch_import import (
    _bn,
    _conv,
    _conv2drelu,
    _scse,
    _sepconv_bn,
)
from enhanced_unet_tpu.models import blocks as jblocks
from enhanced_unet_tpu.ops import resize as jresize
from enhanced_unet_tpu_torch.models import blocks, init_random_weights_
from enhanced_unet_tpu_torch.ops import resize

torch.set_num_threads(1)
F32 = torch.float32


def _close(ours, ref, rel=1e-4):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape
    diff = np.abs(ours - ref).max()
    assert diff <= rel * np.abs(ref).max() + 1e-6, (diff, np.abs(ref).max())


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _sd(module, prefix="m"):
    return {f"{prefix}.{k}": v for k, v in module.state_dict().items()}


def _run(port, flax_mod, variables, x):
    with torch.no_grad():
        ours = _nhwc(port.eval()(_nchw(x)))
    ref = flax_mod.apply(variables, jnp.asarray(x), False)
    _close(ours, ref)


@pytest.mark.parametrize("k,act", [(3, "relu"), (3, None), (1, "relu")])
def test_conv_bn_act(rng, k, act):
    port = init_random_weights_(blocks.ConvBNAct(8, 12, k, act=act, dtype=F32), 1)
    p, s = _conv2drelu(_sd(port), "m")
    ref = jblocks.ConvBNAct(12, (k, k), act=fnn.relu if act else None,
                            dtype=jnp.float32)
    _run(port, ref, {"params": p, "batch_stats": s},
         rng.normal(size=(2, 10, 12, 8)).astype(np.float32))


def test_double_conv(rng):
    port = init_random_weights_(blocks.DoubleConv(6, 10, dtype=F32), 2)
    sd = _sd(port)
    (p0, s0), (p1, s1) = _conv2drelu(sd, "m.conv1"), _conv2drelu(sd, "m.conv2")
    variables = {"params": {"ConvBNAct_0": p0, "ConvBNAct_1": p1},
                 "batch_stats": {"ConvBNAct_0": s0, "ConvBNAct_1": s1}}
    _run(port, jblocks.DoubleConv(10, dtype=jnp.float32), variables,
         rng.normal(size=(1, 9, 11, 6)).astype(np.float32))


def test_scse(rng):
    port = init_random_weights_(blocks.SCSEBlock(32, dtype=F32), 3)
    x = rng.normal(size=(2, 6, 7, 32)).astype(np.float32)
    with torch.no_grad():
        ours = _nhwc(port(_nchw(x)))
    ref = jblocks.SCSEBlock(dtype=jnp.float32).apply(
        {"params": _scse(_sd(port), "m")}, jnp.asarray(x))
    _close(ours, ref)


@pytest.mark.parametrize("dilation", [1, 3])
def test_separable_conv_bn_act(rng, dilation):
    port = init_random_weights_(
        blocks.SeparableConvBNAct(8, 12, dilation, dtype=F32), 4)
    p, s = _sepconv_bn(_sd(port), "m.0.0", "m.0.1", "m.1")
    _run(port, jblocks.SeparableConvBNAct(12, dilation=dilation,
                                          dtype=jnp.float32),
         {"params": p, "batch_stats": s},
         rng.normal(size=(2, 9, 10, 8)).astype(np.float32))


def test_aspp(rng):
    port = init_random_weights_(blocks.ASPP(8, 16, dtype=F32), 5)
    sd = _sd(port)
    p, s = {}, {}
    p["ConvBNAct_0"], s["ConvBNAct_0"] = _conv2drelu(sd, "m.convs.0")
    for b in range(1, 4):
        k = f"m.convs.{b}"
        p[f"SeparableConvBNAct_{b - 1}"], s[f"SeparableConvBNAct_{b - 1}"] = \
            _sepconv_bn(sd, f"{k}.0.0", f"{k}.0.1", f"{k}.1")
    bn_p, bn_s = _bn(sd, "m.convs.4.2")
    p["ConvBNAct_1"] = {"Conv_0": _conv(sd, "m.convs.4.1", bias=False),
                        "BatchNorm_0": bn_p}
    s["ConvBNAct_1"] = {"BatchNorm_0": bn_s}
    p["ConvBNAct_2"], s["ConvBNAct_2"] = _conv2drelu(sd, "m.project")
    _run(port, jblocks.ASPP(16, dtype=jnp.float32),
         {"params": p, "batch_stats": s},
         rng.normal(size=(2, 8, 8, 8)).astype(np.float32))


@pytest.mark.parametrize("size", [(24, 40), (12, 9), (48, 48), (31, 17)])
def test_resize_bilinear(rng, size):
    x = rng.normal(size=(2, 16, 20, 3)).astype(np.float32)
    _close(resize.resize_bilinear(torch.from_numpy(x), size),
           jresize.resize_bilinear(jnp.asarray(x), size))
    _close(resize.resize_bilinear(torch.from_numpy(x[0]), size),
           jresize.resize_bilinear(jnp.asarray(x[0]), size))


@pytest.mark.parametrize("size", [(64, 80), (16, 20), (7, 33)])
def test_resize_align_corners(rng, size):
    x = rng.normal(size=(2, 16, 20, 5)).astype(np.float32)
    _close(resize.resize_bilinear_align_corners(torch.from_numpy(x), size),
           jresize.resize_bilinear_align_corners(jnp.asarray(x), size))


def test_upsample_nearest_and_pad(rng):
    x = rng.normal(size=(2, 5, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        resize.upsample2x_nearest(torch.from_numpy(x)).numpy(),
        np.asarray(jresize.upsample2x_nearest(jnp.asarray(x))))
    y = rng.normal(size=(2, 40, 50, 3)).astype(np.float32)
    ours, pads = resize.pad_to_multiple(torch.from_numpy(y), 32)
    ref, ref_pads = jresize.pad_to_multiple(jnp.asarray(y), 32)
    assert pads == ref_pads == (24, 14)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
