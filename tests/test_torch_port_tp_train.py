"""The port's tensor-parallel train step (`parallel/tensor_parallel.py`
`make_tp_train_step`) against the JAX package's and against the port's own
one-process step.

The port's ranks are spawned gloo processes on the CPU, one thread each
(their function is `tp_ranks.tp_train_rank`, which imports no JAX); the JAX
side runs here on the virtual devices of `conftest.py`.  Held:

- on a 2 x 4 grid, JAX's own case (`tests/test_tensor_parallel.py:67-114`):
  `unet_basic`, `get_preset("unet")`, 8 x 32^2, seeded masks, the weights
  of JAX's `create_train_state` carried by `state_dict_from_jax`, three
  steps: the first loss within rtol 1e-5 of JAX's `make_tp_train_step` on
  `make_mesh_2d(2, 4)` and all three within 5e-3 (later steps drift: AdamW
  turns the ~1e-7 differences of near-zero gradients into whole steps);
  afterwards `DoubleConv_3/ConvBNAct_0/Conv_0/kernel`'s counterpart, its
  gradient and its AdamW moments hold quarter-width shards; every rank
  reports the same loss;
- on the same grid, a batch whose `valid` differs between the data shards
  against JAX's plain jitted step on the whole batch (the focal term's
  sums and count are the whole batch's);
- on a 2 x 2 grid in float64 against the port's one-process
  `make_train_step` on the whole batch, one step: `unet_basic` (`valid`
  differing between the shards), the same with `max_norm` small enough that
  clipping engages, and the tiny-encoder flagship at `min_channels` 16 with
  dropout and stochastic depth on, the generators seeded alike.  Every
  whole parameter's (clipped) gradient on every rank, every split weight's
  slices (and their concatenation over the model axis), the running
  statistics whole on every rank, and the update.  The loss is computed in
  fp32 (the models cast their logits), so float64 holds the gradients to
  about 1e-7 of the tree's largest, not 1e-15; a second step leaves every
  whole parameter, moment and running statistic equal across the ranks;
- at world size 1 in this process: the 1 x 1 grid equals `make_train_step`;
  BatchNorm in train mode called past `models.blocks.batch_norm` raises
  under the mode.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from spatial_ranks import JOIN, port_model
from tp_ranks import tp_train_rank

from enhanced_unet_tpu.config import get_preset as jget_preset
from enhanced_unet_tpu.models import get_model as jget_model
from enhanced_unet_tpu.parallel import make_mesh_2d as jmake_mesh_2d
from enhanced_unet_tpu.parallel import make_tp_train_step as jmake_tp_train_step
from enhanced_unet_tpu.parallel import shard_params_tp as jshard_params_tp
from enhanced_unet_tpu.train.trainer import create_train_state as jcreate_train_state
from enhanced_unet_tpu.train.trainer import make_train_step as jmake_train_step
from enhanced_unet_tpu_torch.config import get_preset
from enhanced_unet_tpu_torch.convert.jax_params import state_dict_from_jax
from enhanced_unet_tpu_torch.parallel import (
    make_mesh_2d,
    make_tp_train_step,
    shard_params_tp,
    spawn,
)
from enhanced_unet_tpu_torch.parallel.tensor_parallel import TensorParallelMode
from enhanced_unet_tpu_torch.train.trainer import create_train_state, make_train_step

torch.set_num_threads(1)
TINY = ("efficientnet-tiny", "efficientnet-tiny")
STEPS = 3


def _spawn(tmp, grid, inputs):
    path = os.path.join(tmp, "inputs.pt")
    torch.save(inputs, path)
    n = grid[0] * grid[1]
    spawn(tp_train_rank, n, (grid, path, tmp), device="cpu", init_dir=tmp, timeout=JOIN)
    return [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False) for r in range(n)]


# ---- 2 x 4 against JAX --------------------------------------------------------

def _batch(seed, n, hw):
    rng = np.random.default_rng(seed)
    images = rng.random((n, hw, hw, 3)).astype(np.float32)
    masks = rng.integers(0, 3, (n, hw, hw)).astype(np.int32)
    return images, masks


def _valid_by_shard(n, hw):
    """All pixels valid in the first data shard's rows; in the second only
    a 20 x 24 corner, as a padded batch gives."""
    valid = np.ones((n, hw, hw), bool)
    valid[n // 2:] = False
    valid[n // 2:, :20, :24] = True
    return valid


@pytest.fixture(scope="module")
def grid24(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("tptrain24"))
    cfg = jget_preset("unet", num_epochs=4)
    jmodel = jget_model("unet_basic", dtype=jnp.float32)
    images, masks = _batch(1, 8, 32)
    ones = np.ones((8, 32, 32), bool)
    valid = _valid_by_shard(8, 32)

    def jstate():
        return jcreate_train_state(jmodel, cfg, steps_per_epoch=1, rng=jax.random.key(0),
                                   input_shape=(1, 32, 32, 3))

    def run(step, state, v):
        losses = []
        for _ in range(STEPS):
            state, metrics = step(state, jnp.asarray(images), jnp.asarray(masks),
                                  jnp.asarray(v), jax.random.key(2))
            losses.append(float(metrics["loss"]))
        return losses

    state = jstate()
    sd = state_dict_from_jax(state.params, state.batch_stats, model_name="unet_basic")
    mesh = jmake_mesh_2d(2, 4)
    want = {"jax_tp": run(jmake_tp_train_step(cfg, mesh), state.replace(
                params=jshard_params_tp(state.params, mesh, min_channels=128)), ones),
            "valid_shards": run(jax.jit(jmake_train_step(cfg, axis_name=None)), jstate(), valid)}
    pcfg = get_preset("unet", num_epochs=4)
    batch = (torch.from_numpy(images), torch.from_numpy(masks))
    inputs = {key: (("unet_basic", sd, {}, torch.float32), 128, pcfg, *batch,
                    torch.from_numpy(v), 0, STEPS)
              for key, v in (("jax_tp", ones), ("valid_shards", valid))}
    return _spawn(tmp, (2, 4), inputs), want


@pytest.mark.parametrize("key", ["jax_tp", "valid_shards"])
def test_2x4_losses_match_jax(grid24, key):
    ranks, want = grid24
    for r in ranks:
        losses = [s["loss"] for s in r[key]]
        np.testing.assert_allclose(losses[0], want[key][0], rtol=1e-5)
        np.testing.assert_allclose(losses, want[key], rtol=5e-3)
        assert losses == [s["loss"] for s in ranks[0][key]]


def test_2x4_update_keeps_quarter_shards(grid24):
    """`DoubleConv_3/ConvBNAct_0/Conv_0/kernel` is `enc4.0.0.weight`
    ([512, 256, 3, 3] whole): a quarter of its output channels, its
    gradient and moments on every rank after the third update; the row
    split `enc4.1.0.weight` a quarter of its input channels."""
    ranks, _ = grid24
    for r in ranks:
        last = r["jax_tp"][-1]
        for tree in ("params", "grads", "mu", "nu"):
            assert tuple(last[tree]["enc4.0.0.weight"].shape) == (128, 256, 3, 3), tree
            assert tuple(last[tree]["enc4.1.0.weight"].shape) == (512, 128, 3, 3), tree


# ---- 2 x 2 in float64 against the one-process step ---------------------------

def _one_process(name, kwargs, dtype, cfg, images, masks, valid, seed, steps,
                 layout=torch.contiguous_format):
    model = port_model(name, None, dtype, **kwargs).to(memory_format=layout)
    state = create_train_state(model, cfg, steps_per_epoch=1, device="cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = make_train_step(cfg)
    gen = torch.Generator().manual_seed(seed)
    state, metrics = step(state, images.to(dtype), masks, valid, gen)
    return {"loss": float(metrics["loss"]), "before": before,
            "params": {n: p.detach().clone() for n, p in model.named_parameters()},
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None},
            "stats": {n: b.clone() for n, b in model.named_buffers()
                      if n.endswith(("running_mean", "running_var"))}}


CASES64 = {
    # key: (model name, kwargs, min_channels, preset, clip norm or None)
    "unet_basic": ("unet_basic", {}, 128, "unet", None),
    "unet_basic_clipped": ("unet_basic", {}, 128, "unet", 0.05),
    "flagship_dropout": ("enhanced_unet", {"encoder_names": TINY}, 16, "enhanced_unet", None),
}


def _cfg(preset, clip):
    cfg = get_preset(preset, num_epochs=4)
    if clip is not None:
        cfg = dataclasses.replace(cfg, optimizer=dataclasses.replace(cfg.optimizer,
                                                                     grad_clip_norm=clip))
    return cfg


@pytest.fixture(scope="module")
def grid22(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("tptrain22"))
    images, masks = _batch(3, 4, 32)
    valid = _valid_by_shard(4, 32)
    batch = (torch.from_numpy(images), torch.from_numpy(masks), torch.from_numpy(valid))
    inputs, want = {}, {}
    for key, (name, kwargs, min_channels, preset, clip) in CASES64.items():
        cfg = _cfg(preset, clip)
        want[key] = _one_process(name, kwargs, torch.float64, cfg, *batch, 5, 1)
        sd = port_model(name, None, torch.float64, **kwargs).state_dict()
        inputs[key] = ((name, sd, kwargs, torch.float64), min_channels, cfg, *batch, 5, 2)
    return _spawn(tmp, (2, 2), inputs), want


@pytest.mark.parametrize("key", sorted(CASES64))
def test_2x2_float64_loss_and_gradients(grid22, key):
    ranks, want = grid22
    w = want[key]
    top = max(g.abs().max().item() for g in w["grads"].values())
    model_ranks = {}
    for r in ranks:
        got = r[key][0]
        np.testing.assert_allclose(got["loss"], w["loss"], rtol=1e-6)
        assert set(got["grads"]) == set(w["grads"])
        j = r["coords"][1]
        for n, g in got["grads"].items():
            want_g = w["grads"][n]
            if g.shape != want_g.shape:           # a split weight: this rank's slice
                dim = next(d for d in range(g.dim()) if g.shape[d] != want_g.shape[d])
                k = g.shape[dim]
                assert 2 * k == want_g.shape[dim], n
                want_g = want_g.narrow(dim, j * k, k)
                model_ranks.setdefault(n, {})[j] = (dim, g)
            torch.testing.assert_close(g, want_g, rtol=1e-5, atol=1e-7 * top, msg=n)
    # the split weights' slices, concatenated over the model axis, are the
    # one process's whole gradient
    assert model_ranks
    for n, parts in model_ranks.items():
        dim = parts[0][0]
        torch.testing.assert_close(torch.cat([parts[0][1], parts[1][1]], dim),
                                   w["grads"][n], rtol=1e-5, atol=1e-7 * top, msg=n)


@pytest.mark.parametrize("key", sorted(CASES64))
def test_2x2_float64_running_stats_whole_on_every_rank(grid22, key):
    """The repaired fault: a slice's BatchNorm used to decay the running
    statistics of the channels a rank does not own, with a local count in
    the variance correction."""
    ranks, want = grid22
    for r in ranks:
        got = r[key][0]["stats"]
        assert set(got) == set(want[key]["stats"])
        for n, b in want[key]["stats"].items():
            torch.testing.assert_close(got[n], b, rtol=1e-9, atol=1e-12, msg=lambda m: f"{n}: {m}")


@pytest.mark.parametrize("key", sorted(CASES64))
def test_2x2_float64_update(grid22, key):
    """The clipped AdamW update: each parameter's move equals the one
    process's (a split weight's slice of it), up to the first step's
    sign-like m / sqrt(v) on gradients within the fp32 loss's noise of 0,
    which can move such an element by a fraction of the learning rate."""
    ranks, want = grid22
    w = want[key]
    lr = _cfg(*CASES64[key][3:]).optimizer.base_lr
    for r in ranks:
        j = r["coords"][1]
        got = r[key][0]["params"]
        for n, p in got.items():
            move = w["params"][n] - w["before"][n]
            if p.shape != move.shape:
                dim = next(d for d in range(p.dim()) if p.shape[d] != move.shape[d])
                k = p.shape[dim]
                move = move.narrow(dim, j * k, k)
                before = w["before"][n].narrow(dim, j * k, k)
            else:
                before = w["before"][n]
            torch.testing.assert_close(p - before, move, rtol=1e-4, atol=1e-2 * lr, msg=n)


def test_2x2_clipping_engaged(grid22):
    """With `max_norm` 0.05 the one process's clipped gradient has norm
    0.05 (it was larger), and so has the grid's, each split weight's
    shards counted once."""
    ranks, want = grid22
    whole_shapes = {n: g.shape for n, g in want["unet_basic_clipped"]["grads"].items()}

    def norm(grads):
        return torch.linalg.vector_norm(torch.stack([g.norm() for g in grads])).item()

    np.testing.assert_allclose(norm(want["unet_basic_clipped"]["grads"].values()), 0.05,
                               rtol=1e-6)
    assert norm(want["unet_basic"]["grads"].values()) > 0.05
    for r in ranks:
        i, j = r["coords"]
        grads = r["unet_basic_clipped"][0]["grads"]
        peer = ranks[2 * i + 1 - j]["unet_basic_clipped"][0]["grads"]
        split = [n for n, g in grads.items() if g.shape != whole_shapes[n]]
        assert split
        parts = list(grads.values()) + [peer[n] for n in split]
        np.testing.assert_allclose(norm(parts), 0.05, rtol=1e-6)


@pytest.mark.parametrize("key", sorted(CASES64))
def test_2x2_second_step_equal_across_ranks(grid22, key):
    """After two steps every whole parameter, its moments and every running
    statistic are bitwise equal on the four ranks, and each split weight and
    its moments on the ranks of one model index."""
    ranks, want = grid22
    for r in ranks:
        j = r["coords"][1]
        for tree in ("params", "mu", "nu", "stats"):
            for n, t in r[key][1][tree].items():
                whole = tree == "stats" or t.shape == want[key]["params"][n].shape
                ref = ranks[0 if whole else j][key][1][tree][n]
                assert torch.equal(t, ref), (tree, n)


# ---- world size 1, in this process --------------------------------------------

@pytest.fixture(scope="module")
def mesh11(tmp_path_factory):
    mesh = make_mesh_2d(1, 1, device="cpu", init_dir=str(tmp_path_factory.mktemp("tptrain11")))
    yield mesh
    dist.destroy_process_group()


@pytest.mark.parametrize("name,kwargs,min_channels,dtype,layout", [
    ("unet_basic", {}, 128, torch.float32, torch.contiguous_format),
    ("unet_basic", {}, 128, torch.float64, torch.contiguous_format),
    ("enhanced_unet", {"encoder_names": TINY}, 16, torch.float64, torch.contiguous_format),
    ("enhanced_unet", {"encoder_names": TINY}, 16, torch.float64, torch.channels_last)])
def test_1x1_equals_make_train_step(mesh11, name, kwargs, min_channels, dtype, layout):
    """fp32 within the noise of two BatchNorm reductions; float64 as on the
    2 x 2 grid.  The tiny flagship's fp32 gradients at batch 2 sit 5e-3 to
    1.4e-2 from its float64 ones (`test_torch_port_train_flagship.py`), so
    it is held in float64 only; once with its weights channels_last, as on
    a card, so that its maps are (dropout draws in its input's memory
    order: a map of another layout would draw another mask)."""
    preset = "enhanced_unet" if name == "enhanced_unet" else "unet"
    cfg = get_preset(preset, num_epochs=4)
    images, masks = _batch(4, 2, 32)
    batch = (torch.from_numpy(images), torch.from_numpy(masks),
             torch.from_numpy(_valid_by_shard(2, 32)))
    want = _one_process(name, kwargs, dtype, cfg, *batch, 6, 1, layout)
    model = port_model(name, None, dtype, **kwargs).to(memory_format=layout)
    model = shard_params_tp(model, mesh11, min_channels)
    state = create_train_state(model, cfg, steps_per_epoch=1, device="cpu")
    state, metrics = make_tp_train_step(cfg, mesh11)(state, batch[0].to(dtype), *batch[1:],
                                                      torch.Generator().manual_seed(6))
    wide = dtype == torch.float64
    np.testing.assert_allclose(float(metrics["loss"]), want["loss"], rtol=1e-6 if wide else 1e-5)
    top = max(g.abs().max().item() for g in want["grads"].values())
    rtol, atol = (1e-5, 1e-7 * top) if wide else (1e-3, 1e-4 * top)
    for n, p in model.named_parameters():
        if n in want["grads"]:
            torch.testing.assert_close(p.grad, want["grads"][n], rtol=rtol, atol=atol,
                                       msg=lambda m, n=n: f"{n}: {m}")
    for n, b in model.named_buffers():
        if n in want["stats"]:
            torch.testing.assert_close(b, want["stats"][n], rtol=1e-9 if wide else 1e-4,
                                       atol=1e-12 if wide else 1e-5, msg=n)


def test_train_mode_batch_norm_outside_blocks_raises(mesh11):
    """Under the mode, train mode's BatchNorm runs through
    `models.blocks.batch_norm` (the whole batch's statistics); a direct
    `F.batch_norm(training=True)` has no rule and raises."""
    x = torch.randn(2, 4, 3, 3)
    with TensorParallelMode(mesh11.model, data=mesh11.data), \
            pytest.raises(NotImplementedError, match="train mode"):
        F.batch_norm(x, torch.zeros(4), torch.ones(4), None, None, True, 0.1, 1e-5)
