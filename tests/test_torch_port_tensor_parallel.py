"""The port's tensor parallelism (`parallel/tensor_parallel.py`) against the
JAX package's (`enhanced_unet_tpu/parallel/tensor_parallel.py`).

The port's ranks are spawned gloo processes on the CPU, one thread each
(their function is in `tp_ranks.py`, which imports no JAX); the JAX side
runs here on the virtual devices of `conftest.py` (`make_mesh_2d` on the
same grid).  Weights are drawn with numpy into the flax tree `jax.eval_shape`
gives and carried by `convert/jax_params.state_dict_from_jax`.  Held:

- `tp_param_specs` against JAX's for every model of `get_model` (the
  flagship with efficientnet-tiny encoders and with b5/b4), at
  `min_channels` 128 and 16: each JAX leaf is given its own constant and
  found in the port's state dict through `state_dict_from_jax` (the
  constants survive its transposes and flips);
- on a 2 x 4 grid, JAX's own case (`tests/test_tensor_parallel.py:46-64`):
  `unet_basic`, batch 4, 32^2, `min_channels=128`, to 1e-4, each rank
  holding 1/4 of `DoubleConv_3/ConvBNAct_0`'s output channels, and the
  forward costing one all-reduce a DoubleConv pair and no all-gather;
- on a 2 x 2 grid, to 2e-4: the flagship with efficientnet-tiny encoders at
  64^2, batch 2, `min_channels` 128 and 16; `linknet` at 16 (its
  transposed convs split on dim 1); `pspnet` at 128 (row splits on pooled
  inputs); and, against the port's own unsharded block, a fused
  `MBConvBlock` whose weights split (K1 on weights gathered whole);
- in this process at world size 1: `make_tp_apply` equals the model; the
  errors: `make_mesh_2d` of the wrong size, `shard_params_tp` of a width
  that does not divide, a model in train mode, grad mode with trainable
  parameters, `MBConvBlock.fold` of a slice.
"""

import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn as nn
from jax.sharding import PartitionSpec as P

from spatial_ranks import JOIN, port_model
from test_torch_port_spatial import jax_variables
from tp_ranks import tp_rank

from enhanced_unet_tpu.models import get_model as jget_model
from enhanced_unet_tpu.parallel import make_mesh_2d as jmake_mesh_2d
from enhanced_unet_tpu.parallel import make_tp_apply as jmake_tp_apply
from enhanced_unet_tpu.parallel import shard_params_tp as jshard_params_tp
from enhanced_unet_tpu.parallel import tp_param_specs as jtp_param_specs
from enhanced_unet_tpu_torch.convert.jax_params import state_dict_from_jax
from enhanced_unet_tpu_torch.models import _REGISTRY, init_random_weights_
from enhanced_unet_tpu_torch.models.blocks import ConvBNAct
from enhanced_unet_tpu_torch.models.encoders import MBConvBlock
from enhanced_unet_tpu_torch.parallel import (
    make_mesh_2d,
    make_tp_apply,
    shard_params_tp,
    spawn,
    tp_param_specs,
)

torch.set_num_threads(1)
TINY = ("efficientnet-tiny", "efficientnet-tiny")
B5B4 = ("efficientnet-b5", "efficientnet-b4")
UNCALLED = "unetpp.decoder.blocks.x_0_4.attention1."
# (model name, encoder pair) of each spec case: the eleven names, the
# flagship also at full width
SPEC_CASES = {name: (name, None) for name in _REGISTRY if name != "enhanced_unet"}
SPEC_CASES.update({"enhanced_unet_tiny": ("enhanced_unet", TINY),
                   "enhanced_unet_b5b4": ("enhanced_unet", B5B4)})


# ---- tp_param_specs against JAX's ------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_shapes(name, variants):
    kwargs = {} if variants is None else {"encoder_names": variants}
    jmodel = jget_model(name, dtype=jnp.float32, **kwargs)
    return jax.eval_shape(lambda k, x: jmodel.init(k, x, False), jax.random.PRNGKey(0),
                          jnp.zeros((1, 64, 64, 3), jnp.float32))


@functools.lru_cache(maxsize=None)
def _leaf_of_key(name, variants):
    """Port state-dict key -> the index of the flax params leaf it carries
    (keys that carry a `batch_stats` leaf or none are left out)."""
    shapes = _jax_shapes(name, variants)
    params = jax.tree_util.tree_leaves(shapes["params"])
    stats = shapes.get("batch_stats", {})

    def ids(tree, start):
        leaves, treedef = jax.tree_util.tree_flatten(tree)
        return jax.tree_util.tree_unflatten(
            treedef, [np.broadcast_to(np.float32(start + i + 1), leaf.shape)
                      for i, leaf in enumerate(leaves)])

    sd = state_dict_from_jax(ids(shapes["params"], 0), ids(stats, len(params)),
                             **({"model_name": name} if variants is None else
                                {"variants": variants}))
    out = {}
    for key, t in sd.items():
        v = t.flatten()[0].item() if t.numel() else 0.0
        if 1 <= v <= len(params) and bool((t == v).all()):
            out[key] = int(v) - 1
        else:                         # a statistic, or zeros the tree has no leaf for
            assert v > len(params) or key.endswith("num_batches_tracked") \
                or key.startswith(UNCALLED), key
    return out


@pytest.mark.parametrize("min_channels", [128, 16])
@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_specs_match_jax(case, min_channels):
    name, variants = SPEC_CASES[case]
    shapes = _jax_shapes(name, variants)
    jspecs = jax.tree_util.tree_leaves(jtp_param_specs(shapes["params"], min_channels),
                                       is_leaf=lambda s: isinstance(s, P))
    kwargs = {} if variants is None else {"encoder_names": variants}
    with torch.device("meta"):
        model = _REGISTRY[name](dtype=torch.float32, **kwargs)
    specs = tp_param_specs(model, min_channels)
    assert set(specs) == set(model.state_dict())
    leaf_of = _leaf_of_key(name, variants)
    splits = {"column": 0, "row": 0}
    for key, leaf in leaf_of.items():
        spec = jspecs[leaf]
        axis = None if spec == P() else list(spec).index("model")
        if axis is None:
            want = None
        else:                         # flax HWIO (Cin at 2, Cout at 3) -> the port's dim
            transposed = isinstance(model.get_submodule(key.rsplit(".", 1)[0]),
                                    nn.ConvTranspose2d)
            want = {2: 0, 3: 1}[axis] if transposed else {2: 1, 3: 0}[axis]
            splits["row" if axis == 2 else "column"] += 1
        assert specs[key] == want, (key, spec)
    assert not {k for k, d in specs.items() if d is not None} - set(leaf_of) - {
        k for k in specs if k.startswith(UNCALLED)}
    if case == "enhanced_unet_b5b4" and min_channels == 128:
        assert splits == {"column": 267, "row": 4}


# ---- forwards on 2 x 4 and 2 x 2 grids against JAX's -----------------------

def _jax_tp(jmodel, v, x, grid, min_channels):
    mesh = jmake_mesh_2d(*grid)
    params = jshard_params_tp(v["params"], mesh, min_channels=min_channels)
    return np.asarray(jmake_tp_apply(jmodel, mesh)(
        {"params": params, "batch_stats": v.get("batch_stats", {})}, jnp.asarray(x)))


def _spawn(tmp, grid, inputs):
    path = os.path.join(tmp, "inputs.pt")
    torch.save(inputs, path)
    n = grid[0] * grid[1]
    spawn(tp_rank, n, (grid, path, tmp), device="cpu", init_dir=tmp, timeout=JOIN)
    return [torch.load(os.path.join(tmp, f"out{r}.pt")) for r in range(n)]


def _logits(ranks, key, grid):
    """The whole batch's logits from the first rank of each grid row, and
    whether every rank of a row holds the same."""
    rows = [ranks[i * grid[1]][key]["logits"] for i in range(grid[0])]
    same = all(torch.equal(ranks[i * grid[1] + j][key]["logits"], rows[i])
               for i in range(grid[0]) for j in range(grid[1]))
    return torch.cat(rows).numpy(), same


@pytest.fixture(scope="module")
def grid24(tmp_path_factory):
    """JAX's own case: `unet_basic`, batch 4, 32^2, on 2 x 4 at 128."""
    tmp = str(tmp_path_factory.mktemp("tp24"))
    jmodel = jget_model("unet_basic", dtype=jnp.float32)
    v = jax_variables(jmodel, (32, 32), 0)
    x = np.random.default_rng(0).random((4, 32, 32, 3)).astype(np.float32)
    want = _jax_tp(jmodel, v, x, (2, 4), 128)
    sd = state_dict_from_jax(v["params"], v["batch_stats"], model_name="unet_basic")
    ranks = _spawn(tmp, (2, 4), {"unet_basic": (("unet_basic", sd, {}), 128,
                                                torch.from_numpy(x))})
    return ranks, want


def test_unet_basic_2x4_matches_jax(grid24):
    ranks, want = grid24
    got, same = _logits(ranks, "unet_basic", (2, 4))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert same


def test_unet_basic_2x4_holds_quarter_shards(grid24):
    ranks, _ = grid24
    assert [r["coords"] for r in ranks] == [(i, j) for i in range(2) for j in range(4)]
    full = dict(port_model("unet_basic").named_parameters())
    for r in ranks:
        split = r["unet_basic"]["split"]
        # DoubleConv_3/ConvBNAct_0: a quarter of its output channels
        assert split["enc4.0.0.weight"] == (512 // 4, 256, 3, 3)
        assert split["enc4.1.0.weight"] == (512, 512 // 4, 3, 3)
        assert 4 * sum(np.prod(s) for s in split.values()) == sum(
            full[n].numel() for n in split)


def test_unet_basic_double_conv_pairs_cost_one_all_reduce(grid24):
    """enc2..enc4, dec4 and dec3 are pairs of wide convs (a column then a
    row split): one all-reduce each and no all-gather in the forward."""
    ranks, _ = grid24
    for r in ranks:
        counts = r["unet_basic"]["counts"]
        assert counts["all_reduce"] == 5 and counts["all_gather"] == 0, counts
        assert counts["k2_column"] == counts["k2_row"] == 5, counts


@pytest.fixture(scope="module")
def grid22(tmp_path_factory):
    """The 2 x 2 cases, in one spawn."""
    tmp = str(tmp_path_factory.mktemp("tp22"))
    rng = np.random.default_rng(1)
    inputs, want = {}, {}
    for key, name, kwargs, min_channels, seed in (
            ("flagship_128", "enhanced_unet", {"encoder_names": TINY}, 128, 2),
            ("flagship_16", "enhanced_unet", {"encoder_names": TINY}, 16, 2),
            ("linknet_16", "linknet", {}, 16, 3),
            ("pspnet_128", "pspnet", {}, 128, 4)):
        jmodel = jget_model(name, dtype=jnp.float32, **kwargs)
        v = jax_variables(jmodel, (64, 64), seed)
        x = rng.random((2, 64, 64, 3)).astype(np.float32)
        want[key] = _jax_tp(jmodel, v, x, (2, 2), min_channels)
        sd = state_dict_from_jax(v["params"], v.get("batch_stats", {}), model_name=name,
                                 **({"variants": TINY} if kwargs else {}))
        inputs[key] = ((name, sd, kwargs), min_channels, torch.from_numpy(x))
    block = init_random_weights_(MBConvBlock(16, 16, 1, 1, 3, fused=True,
                                             dtype=torch.float32), 5).eval()
    x = torch.from_numpy(rng.normal(size=(2, 16, 12, 10)).astype(np.float32))
    with torch.no_grad():
        want["k1_block"] = block(x).numpy()
    inputs["k1_block"] = (block, 16, x)
    return _spawn(tmp, (2, 2), inputs), want


@pytest.mark.parametrize("key", ["flagship_128", "flagship_16", "linknet_16", "pspnet_128",
                                 "k1_block"])
def test_2x2_matches(grid22, key):
    ranks, want = grid22
    got, same = _logits(ranks, key, (2, 2))
    np.testing.assert_allclose(got, want[key], rtol=2e-4, atol=2e-4)
    assert same


def test_2x2_splits(grid22):
    """What each case split: the flagship's fusion head (6 -> 256 column,
    256 -> 128 row) and at 16 its depthwise convs; LinkNet's transposed
    convs on dim 1; the K1 block's weights, gathered whole for the call."""
    ranks, _ = grid22
    for r in ranks:
        head = r["flagship_128"]["split"]
        assert head["fusion_head.0.weight"] == (128, 6, 3, 3)
        assert head["fusion_head.4.weight"] == (128, 128, 3, 3)
        dw = r["flagship_16"]["split"]
        assert dw["unetpp.encoder._blocks.3._depthwise_conv.weight"][1] == 1
        up = r["linknet_16"]["split"]["model.decoder.blocks.0.up.weight"]
        assert up == (32, 16, 3, 3)
        assert r["k1_block"]["counts"]["k1_gathered"] == 1
        assert r["k1_block"]["split"]["_depthwise_conv.weight"] == (8, 1, 3, 3)


def test_2x2_axes_are_meshes_of_the_grid(grid22):
    """Global rank r sits at (r // 2, r % 2); `data` holds the ranks of its
    model index, `model` those of its data index, and each axis's
    broadcast, mean and barrier run within it."""
    ranks, _ = grid22
    for r, out in enumerate(ranks):
        i, j = divmod(r, 2)
        assert out["coords"] == (i, j)
        assert out["data"] == (i, 2, float(j), j + 1.0)         # ranks j, j + 2
        assert out["model"] == (j, 2, float(2 * i), 2 * i + 0.5)  # ranks 2i, 2i + 1


# ---- world size 1, in this process ------------------------------------------

@pytest.fixture(scope="module")
def mesh11(tmp_path_factory):
    mesh = make_mesh_2d(1, 1, device="cpu", init_dir=str(tmp_path_factory.mktemp("tp11")))
    yield mesh
    dist.destroy_process_group()


@pytest.mark.parametrize("name", ["unet_basic", "enhanced_unet"])
def test_1x1_equals_the_model(mesh11, name):
    kwargs = {"encoder_names": TINY} if name == "enhanced_unet" else {}
    model = port_model(name, **kwargs)
    x = torch.from_numpy(np.random.default_rng(6).random((2, 32, 32, 3), dtype=np.float32))
    with torch.no_grad():
        want = model(x)[0]
        shard_params_tp(model, mesh11, 16)
        got = make_tp_apply(model, mesh11)(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_errors(mesh11):
    with pytest.raises(ValueError, match="requested 4 devices"):
        make_mesh_2d(2, 2, device="cpu")
    model = nn.Sequential(ConvBNAct(3, 6, dtype=torch.float32))
    grid = types.SimpleNamespace(model=types.SimpleNamespace(rank=0, size=4))
    with pytest.raises(ValueError, match=r"0\.0\.weight: 6 channels .* over 4 ranks"):
        shard_params_tp(model, grid, min_channels=4)
    model = port_model("unet_basic")
    shard_params_tp(model, mesh11)
    with pytest.raises(RuntimeError, match="no backward"):
        make_tp_apply(model, mesh11)(torch.zeros(1, 16, 16, 3))
    with torch.no_grad(), pytest.raises(ValueError, match="eval mode"):
        make_tp_apply(model.train(), mesh11)(torch.zeros(1, 16, 16, 3))
    with pytest.raises(ValueError, match="sharded already"):
        shard_params_tp(model, mesh11)
    block = MBConvBlock(16, 16, 1, 1, 3, fused=True, dtype=torch.float32).eval()
    shard_params_tp(block, mesh11, 16)
    with pytest.raises(ValueError, match="channel slices"):
        block.fold()


@pytest.mark.slow
def test_flagship_b0_2x4_matches_jax(tmp_path):
    """JAX's `tests/test_tensor_parallel.py:117-145`: the flagship with b0
    encoders, batch 2, 64^2, on 2 x 4 at 128, to 2e-4."""
    b0 = ("efficientnet-b0", "efficientnet-b0")
    jmodel = jget_model("enhanced_unet", dtype=jnp.float32, encoder_names=b0)
    v = jax_variables(jmodel, (64, 64), 9)
    x = np.random.default_rng(9).random((2, 64, 64, 3)).astype(np.float32)
    want = _jax_tp(jmodel, v, x, (2, 4), 128)
    sd = state_dict_from_jax(v["params"], v["batch_stats"], variants=b0)
    ranks = _spawn(str(tmp_path), (2, 4), {"b0": (("enhanced_unet", sd, {"encoder_names": b0}),
                                                  128, torch.from_numpy(x))})
    got, same = _logits(ranks, "b0", (2, 4))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert same
