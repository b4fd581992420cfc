"""`make_spatial_apply` of the port over 4 gloo ranks on the CPU against the
JAX package's unsharded `model.apply`, for the nine models of `get_model`
that `test_torch_port_spatial.py` does not hold against JAX's spatial
functions.

Each model runs at its smallest legal size, H = 4 ranks x its total stride
(W = the stride, at least 16), so that its deepest band holds one row: the
ResNet stem's 3x3 stride-2 max pool, FCN's and PSPNet's resizes to sizes
read from bands, PSPNet's adaptive pools (bins 2, 3 and 6 over four
one-row bands) and LinkNet's transposed convs (2H + 1 rows, the last
dropped) all cross bands.  Weights are drawn with numpy into the flax tree
and carried by `state_dict_from_jax`; one spawn runs every model, and each
model is its own case.  Tolerance: max |diff| <= 1e-4 of max |logit|.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_ranks import JOIN, apply_rank
from test_torch_port_spatial import close, jax_variables

from enhanced_unet_tpu.models import get_model as jget_model
from enhanced_unet_tpu_torch.convert.jax_params import state_dict_from_jax
from enhanced_unet_tpu_torch.parallel import spawn

torch.set_num_threads(1)
RANKS = 4
# each model's total stride
STRIDE = {"segnet": 16, "unet": 32, "enhanced_unet_basic": 8, "fcn": 16, "fcn_basic": 4,
          "pspnet": 16, "pspnet_basic": 4, "linknet": 8, "linknet_basic": 4}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("spatial_zoo"))
    rng = np.random.default_rng(0)
    inputs, want = {}, {}
    for k, (name, stride) in enumerate(STRIDE.items()):
        hw = (RANKS * stride, max(stride, 16))
        jmodel = jget_model(name, dtype=jnp.float32)
        v = jax_variables(jmodel, hw, 10 + k)
        x = rng.random((1, *hw, 3)).astype(np.float32)
        want[name] = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, False)[0])(
            v, jnp.asarray(x)))
        inputs[name] = (name, state_dict_from_jax(v["params"], v.get("batch_stats", {}),
                                                  model_name=name), {}, torch.from_numpy(x))
    path = os.path.join(tmp, "inputs.pt")
    torch.save(inputs, path)
    spawn(apply_rank, RANKS, (path, tmp), device="cpu", init_dir=tmp, timeout=JOIN)
    return [torch.load(os.path.join(tmp, f"out{r}.pt")) for r in range(RANKS)], want


@pytest.mark.parametrize("name", sorted(STRIDE))
def test_spatial_apply_matches_unsharded_jax(run, name):
    ranks, want = run
    close(ranks[0][name].numpy(), want[name], 1e-4)
    for r in range(1, RANKS):
        assert torch.equal(ranks[r][name], ranks[0][name])
