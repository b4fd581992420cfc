"""PyTorch port vs JAX package: the EfficientNet encoder and the flagship
EnhancedUNet, on the same seeded weights.

The port's weights are random (seeded) with non-identity BatchNorm
statistics; the JAX variables come from them through
`enhanced_unet_tpu.convert.torch_import`.  fp32 on the CPU; tolerance:
max |diff| <= 1e-4 of the reference's max |value| (fp32 summation-order
noise only).  In the port the stage-0 encoder blocks and the 3x3 ConvBNActs
run through the kernel wrappers, i.e. their plain versions here.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from enhanced_unet_tpu.convert.torch_import import (
    convert_efficientnet,
    convert_enhanced_unet,
)
from enhanced_unet_tpu.models.encoders import EfficientNetEncoder as JEncoder
from enhanced_unet_tpu.models.enhanced_unet import EnhancedUNet as JEnhancedUNet
from enhanced_unet_tpu_torch.models import get_model, init_random_weights_
from enhanced_unet_tpu_torch.models.encoders import EfficientNetEncoder

torch.set_num_threads(1)
TINY = ("efficientnet-tiny", "efficientnet-tiny")


def _close(ours, ref, rel=1e-4):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape
    diff = np.abs(ours - ref).max()
    assert diff <= rel * np.abs(ref).max() + 1e-6, (diff, np.abs(ref).max())


@pytest.mark.parametrize("output_stride", [32, 16])
def test_encoder_features_match_jax(rng, output_stride):
    port = EfficientNetEncoder("efficientnet-tiny", output_stride,
                               dtype=torch.float32)
    init_random_weights_(port, 11).eval()
    params, stats = convert_efficientnet(port.state_dict(), "efficientnet-tiny")
    x = (rng.random((2, 64, 64, 3)) - 0.5).astype(np.float32)
    with torch.no_grad():
        ours = port(torch.from_numpy(np.transpose(x, (0, 3, 1, 2)).copy()))
    ref = JEncoder(variant="efficientnet-tiny", output_stride=output_stride,
                   dtype=jnp.float32).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), False)
    assert len(ours) == len(ref) == 6
    assert [f.shape[1] for f in ours] == port.out_channels
    for a, b in zip(ours, ref):
        _close(a.permute(0, 2, 3, 1).numpy(), b)


def _flagship_pair(encoders, fusion_stride, packed_decoder, seed):
    port = get_model("enhanced_unet", dtype=torch.float32, device="cpu",
                     seed=seed, encoder_names=encoders,
                     fusion_stride=fusion_stride)
    params, stats = convert_enhanced_unet(port.state_dict(), encoders)
    ref = JEnhancedUNet(encoder_names=encoders, fusion_stride=fusion_stride,
                        packed_decoder=packed_decoder, dtype=jnp.float32)
    return port, ref, {"params": params, "batch_stats": stats}


def _check_flagship(port, ref, variables, x):
    with torch.no_grad():
        logits, aux = port(torch.from_numpy(x))
    ref_logits, ref_aux = jax.jit(lambda v, x: ref.apply(v, x, False))(
        variables, jnp.asarray(x))
    assert logits.dtype == torch.float32 and logits.shape == x.shape
    _close(logits.numpy(), ref_logits)
    for k in ("unetpp", "deeplab"):
        _close(aux[k].numpy(), ref_aux[k])


@pytest.mark.parametrize("fusion_stride", [1, 2])
@pytest.mark.parametrize("packed_decoder", [False, True])
def test_flagship_tiny_matches_jax(rng, packed_decoder, fusion_stride):
    port, ref, variables = _flagship_pair(TINY, fusion_stride, packed_decoder, 3)
    x = (rng.random((2, 64, 64, 3)) - 0.5).astype(np.float32)
    _check_flagship(port, ref, variables, x)


@pytest.mark.slow
def test_flagship_b5_b4_matches_jax(rng):
    port, ref, variables = _flagship_pair(
        ("efficientnet-b5", "efficientnet-b4"), 1, True, 4)
    x = (rng.random((1, 64, 64, 3)) - 0.5).astype(np.float32)
    _check_flagship(port, ref, variables, x)
