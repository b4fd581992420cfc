"""The port's weight carrier: `state_dict_from_jax` is the exact inverse of
the JAX package's `convert_enhanced_unet`, and its output loads strictly
into the port (reference state-dict names, the unused head-block
attention1 included)."""

import numpy as np
import pytest
import torch

import jax

from enhanced_unet_tpu.convert.torch_import import convert_enhanced_unet
from enhanced_unet_tpu_torch.convert import state_dict_from_jax
from enhanced_unet_tpu_torch.models import get_model

torch.set_num_threads(1)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("encoders", [
    ("efficientnet-tiny", "efficientnet-tiny"),
    ("efficientnet-b5", "efficientnet-b4"),
])
def test_state_dict_from_jax_round_trip(encoders):
    port = get_model("enhanced_unet", dtype=torch.float32, device="cpu",
                     seed=5, encoder_names=encoders)
    params, stats = convert_enhanced_unet(port.state_dict(), encoders)
    sd = state_dict_from_jax(params, stats, encoders)
    params2, stats2 = convert_enhanced_unet(sd, encoders)
    for a, b in ((params, params2), (stats, stats2)):
        la, lb = _leaves(a), _leaves(b)
        assert la.keys() == lb.keys()
        for k in la:
            np.testing.assert_array_equal(la[k], lb[k], err_msg=k)

    # strict load into a fresh port: every key present, every shape right
    fresh = get_model("enhanced_unet", dtype=torch.float32, device="cpu",
                      seed=6, encoder_names=encoders)
    fresh.load_state_dict(sd, strict=True)
    own = port.state_dict()
    for k, v in fresh.state_dict().items():
        if ".x_0_4.attention1." in k or k.endswith("num_batches_tracked"):
            continue
        torch.testing.assert_close(v, own[k], rtol=0, atol=0, msg=k)
