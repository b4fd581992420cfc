"""The port's data axis against the JAX package's `parallel/`.

Two gloo ranks on the CPU (fp32, one thread each) run the data-parallel
step of `unet_basic` at 32^2 on a global batch of 8, as
`tests/test_parallel.py`, from weights carried out of the JAX tree by
`convert/jax_params.py` (the rank functions are in
`test_torch_port_spawn.py`).  Held:

- against JAX's `make_dp_train_step` on `make_mesh(2)`: the loss and every
  `batch_stats` leaf after one step (1e-5 of the leaf's largest value);
- across the ranks: every parameter and running statistic after an AdamW
  step, bitwise;
- against the port's own one-process emulation (each half-batch through
  the plain step, the means taken by hand): the gradients handed to the
  optimizer, the loss and the running statistics (1e-6 relative);
- against JAX's per-replica gradients averaged by hand: relative L2 below
  1e-2 per leaf, leaves of noise-level norm skipped, as
  `tests/test_parallel.py`, JAX's in float64: the port's fp32 step, and
  the same step on the same ranks in float64 (1e-6);
- `tiled_inference_sharded` on two ranks against JAX's on `make_mesh(2)`
  and the port's one-device `tiled_inference` (1e-5), on a 12-tile and a
  9-tile grid (padded to a multiple of the ranks);
- `train_model(num_devices=2, device="cpu")`: one epoch on a synthetic
  folder through spawned workers, then a one-rank resume of its
  checkpoint; and `train_model` as the two ranks of an initialised group,
  where rank 0 alone writes the checkpoints and the ranks end with the
  same weights.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthdata import make_synthetic_dataset
from test_torch_port_spawn import JOIN, RecordingTx, dp_rank, dp_state, pointwise_apply, train_rank

from enhanced_unet_tpu.config import get_preset as jget_preset
from enhanced_unet_tpu.models import get_model as jget_model
from enhanced_unet_tpu.ops.losses import combined_loss_with_aux
from enhanced_unet_tpu.parallel import make_dp_train_step as jmake_dp_train_step
from enhanced_unet_tpu.parallel import make_mesh as jmake_mesh
from enhanced_unet_tpu.parallel import replicate_state as jreplicate_state
from enhanced_unet_tpu.parallel import shard_batch as jshard_batch
from enhanced_unet_tpu.parallel import tiled_inference_sharded as jtiled_sharded
from enhanced_unet_tpu.train.trainer import create_train_state as jcreate_train_state
from enhanced_unet_tpu_torch.config import get_preset
from enhanced_unet_tpu_torch.convert import state_dict_from_jax
from enhanced_unet_tpu_torch.convert.jax_params import _param_tree_to_port
from enhanced_unet_tpu_torch.ops.tiling import tiled_inference
from enhanced_unet_tpu_torch.parallel import data_parallel, replica_seed, spawn
from enhanced_unet_tpu_torch.train import api
from enhanced_unet_tpu_torch.train.checkpoint import checkpoint_exists, load_checkpoint
from enhanced_unet_tpu_torch.train.trainer import make_train_step

torch.set_num_threads(1)
TILED_HW = ((150, 200), (160, 160))       # 3 x 4 = 12 tiles, 3 x 3 = 9 tiles


def _numpy_tree(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX step, the JAX per-replica gradients and tiles, and both
    ranks' outputs."""
    tmp = tmp_path_factory.mktemp("dp")
    cfg = jget_preset("unet", num_epochs=4)
    jstate = jcreate_train_state(jget_model("unet_basic", dtype=jnp.float32), cfg,
                                 steps_per_epoch=2, rng=jax.random.key(0),
                                 input_shape=(2, 32, 32, 3))
    params, stats = _numpy_tree(jstate.params), _numpy_tree(jstate.batch_stats)
    rng = np.random.default_rng(0)
    images = rng.random((8, 32, 32, 3)).astype(np.float32)
    masks = rng.integers(0, 3, (8, 32, 32)).astype(np.int32)
    valid = np.ones((8, 32, 32), bool)
    tiled = [rng.random((h, w, 3)).astype(np.float32) for h, w in TILED_HW]

    # JAX's per-replica gradients in float64, each with its replica's key
    with jax.enable_x64(True):
        model64 = jget_model("unet_basic", dtype=jnp.float64)
        p64, s64 = (jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)
                    for t in (params, stats))

        def loss_fn(p, img, msk, vld, key):
            (logits, aux), _ = model64.apply(
                {"params": p, "batch_stats": s64}, img, train=True,
                mutable=["batch_stats"], rngs={"dropout": key})
            return combined_loss_with_aux(logits, aux, msk, cfg.loss, vld)

        grad_fn = jax.jit(jax.grad(loss_fn))
        step_key = jax.random.fold_in(jax.random.key(1), 0)
        replica_grads = [_numpy_tree(grad_fn(p64, images[4 * i:4 * i + 4].astype(np.float64),
                                             masks[4 * i:4 * i + 4], valid[4 * i:4 * i + 4],
                                             jax.random.fold_in(step_key, i)))
                         for i in range(2)]
    jax_grads = jax.tree.map(lambda a, b: (a + b) / 2.0, *replica_grads)

    mesh = jmake_mesh(2)
    jtiles = [np.asarray(jtiled_sharded(
        lambda t: jnp.concatenate([t.mean(-1, keepdims=True), 1.0 - t.mean(-1, keepdims=True),
                                   jnp.zeros_like(t[..., :1])], -1),
        jnp.asarray(img), mesh, tile=64, overlap=16)) for img in tiled]
    new_state, metrics = jmake_dp_train_step(cfg, mesh)(
        jreplicate_state(jstate, mesh), *jshard_batch(
            (jnp.asarray(images), jnp.asarray(masks), jnp.asarray(valid)), mesh),
        jax.random.key(1))

    state_dict = state_dict_from_jax(params, stats, model_name="unet_basic")
    inputs = {"state_dict": state_dict, "images": torch.from_numpy(images),
              "masks": torch.from_numpy(masks).long(), "valid": torch.from_numpy(valid),
              "tiled": [torch.from_numpy(t) for t in tiled]}
    torch.save(inputs, tmp / "inputs.pt")
    spawn(dp_rank, 2, (str(tmp / "inputs.pt"), str(tmp)), device="cpu",
          init_dir=str(tmp), timeout=JOIN)
    ranks = [torch.load(tmp / f"rank{r}.pt") for r in range(2)]
    return {
        "inputs": inputs, "ranks": ranks, "tiled": tiled, "jtiles": jtiles,
        "jax_loss": float(metrics["loss"]),
        "jax_stats": state_dict_from_jax(_numpy_tree(new_state.params),
                                         _numpy_tree(new_state.batch_stats),
                                         model_name="unet_basic"),
        "jax_grads": _param_tree_to_port(jax_grads, ("", ""), "unet_basic"),
    }


def _rel(ours, ref):
    """max |ours - ref| over max |ref| (0 when both are 0)."""
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max()
    diff = np.abs(ours - ref).max()
    return diff / scale if scale else diff


def test_dp_step_loss_and_batch_stats_match_jax(run):
    for rank in run["ranks"]:
        assert rank["loss"] == pytest.approx(run["jax_loss"], rel=1e-5)
        assert rank["adamw_loss"] == rank["loss"]
        assert set(rank["stats"]) == {n for n in run["jax_stats"]
                                      if n.endswith(("running_mean", "running_var"))}
        for name, value in rank["stats"].items():
            assert _rel(value, run["jax_stats"][name]) <= 1e-5, name


def test_dp_step_keeps_the_ranks_bitwise_equal(run):
    a, b = (r["adamw_state"] for r in run["ranks"])
    assert a.keys() == b.keys()
    for name in a:
        assert torch.equal(a[name], b[name]), name
    moved = [n for n, t in a.items() if t.is_floating_point()
             and not torch.equal(t, run["inputs"]["state_dict"][n])]
    assert len(moved) == len([n for n, t in a.items() if t.is_floating_point()])


def test_dp_step_reduces_like_the_one_process_emulation(run):
    grads, losses, stats = [], [], []
    for r in range(2):
        cfg, state = dp_state(run["inputs"]["state_dict"])
        state.tx = RecordingTx()
        rows = slice(4 * r, 4 * r + 4)
        gen = torch.Generator().manual_seed(
            replica_seed(1, type("M", (), {"rank": r, "size": 2})))
        _, m = make_train_step(cfg)(state, run["inputs"]["images"][rows],
                                    run["inputs"]["masks"][rows],
                                    run["inputs"]["valid"][rows], gen)
        grads.append(state.tx.grads)
        losses.append(m["loss"].item())
        stats.append({n: b for n, b in state.model.named_buffers()
                      if n.endswith(("running_mean", "running_var"))})
    for rank in run["ranks"]:
        assert rank["grads"].keys() == grads[0].keys()
        for name, g in rank["grads"].items():
            assert _rel(g, (grads[0][name] + grads[1][name]) / 2) <= 1e-6, name
        assert rank["loss"] == pytest.approx((losses[0] + losses[1]) / 2, rel=1e-6)
        for name, value in rank["stats"].items():
            assert _rel(value, (stats[0][name] + stats[1][name]) / 2) <= 1e-6, name


@pytest.mark.parametrize("key,tol", [("grads", 1e-2), ("grads64", 1e-6)])
def test_dp_step_gradients_match_jax_replicas_averaged(run, key, tol):
    # JAX in float64: its fp32 gradients sit about 1e-2 from its float64
    # ones at the first conv (train-mode BatchNorm over 4 rows a replica);
    # the port's fp32 step is held at 1e-2, its float64 step at 1e-6
    ours = run["ranks"][0][key]
    assert ours.keys() == run["jax_grads"].keys()
    checked = 0
    for name, ref in run["jax_grads"].items():
        a = ours[name].double().numpy().ravel()
        b = ref.double().numpy().ravel()
        denom = np.linalg.norm(b)
        if denom < 1e-4:
            continue  # a noise-level gradient
        assert np.linalg.norm(a - b) / denom < tol, name
        checked += 1
    assert checked > len(ours) // 2


@pytest.mark.parametrize("i", range(len(TILED_HW)))
def test_tiled_sharded_matches_jax_and_one_device(run, i):
    image = run["tiled"][i]
    single = tiled_inference(pointwise_apply, torch.from_numpy(image), tile=64, overlap=16,
                             batch_size=8)
    for rank in run["ranks"]:
        ours = rank["tiled"][i]
        assert tuple(ours.shape) == (*TILED_HW[i], 3) and ours.dtype == torch.float32
        np.testing.assert_allclose(ours.numpy(), run["jtiles"][i], atol=1e-5)
        np.testing.assert_allclose(ours.numpy(), single.numpy(), atol=1e-5)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cells")
    make_synthetic_dataset(str(d), n_images=7, size=64, seed=6)   # train 4, val 1, test 2
    return str(d)


def _cfg(data_dir, epochs):
    return dataclasses.replace(get_preset("unet_basic", num_epochs=epochs, data_dir=data_dir),
                               num_epochs=epochs, eval_every_epochs=1)


def test_train_model_on_two_cpu_ranks_then_resume_on_one(data_dir, tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(api, "spawn", functools.partial(data_parallel.spawn, timeout=JOIN))
    ck = str(tmp_path / "ck")
    best = api.train_model("unet_basic", data_dir, 1, checkpoint_dir=ck, max_size=64,
                           cfg=_cfg(data_dir, 1), dtype=torch.float32, num_devices=2,
                           use_full_evaluator_gate=False, log=print, device="cpu")
    last = os.path.join(ck, "unet_basic", "last_model")
    assert best == os.path.join(ck, "unet_basic", "best_model")
    assert checkpoint_exists(best) and checkpoint_exists(last)
    assert sorted(os.listdir(os.path.join(ck, "unet_basic"))) == ["best_model", "last_model"]
    logs = []
    api.train_model("unet_basic", data_dir, 2, checkpoint_dir=ck, max_size=64,
                    cfg=_cfg(data_dir, 2), dtype=torch.float32, resume=True,
                    use_full_evaluator_gate=False, log=logs.append, device="cpu")
    assert any(line.startswith(f"Resuming from {last} at epoch 1") for line in logs), logs
    assert any(line.startswith("Epoch 2/2") for line in logs), logs


def test_train_model_as_the_ranks_of_a_group(data_dir, tmp_path):
    ck = str(tmp_path / "ck")
    kwargs = dict(data_dir=data_dir, num_epochs=1, checkpoint_dir=ck, max_size=64,
                  cfg=_cfg(data_dir, 1), dtype=torch.float32, num_devices=2)
    spawn(train_rank, 2, ("unet_basic", kwargs, str(tmp_path)), device="cpu",
          init_dir=str(tmp_path), timeout=JOIN)
    ranks = [torch.load(tmp_path / f"train_rank{r}.pt") for r in range(2)]
    assert ranks[0]["saved"] and set(ranks[0]["saved"]) <= {"best_model", "last_model"}
    assert "last_model" in ranks[0]["saved"] and ranks[1]["saved"] == []
    assert ranks[0]["best"] == ranks[1]["best"] == os.path.join(ck, "unet_basic", "best_model")
    _, state = dp_state(ranks[0]["state_dict"])
    state, meta = load_checkpoint(os.path.join(ck, "unet_basic", "last_model"), state)
    for name, value in state.model.state_dict().items():
        assert torch.equal(value, ranks[0]["state_dict"][name]), name
        assert torch.equal(value, ranks[1]["state_dict"][name]), name
    assert meta["epoch"] == 1 and len(meta["history"]["val_miou"]) == 1
