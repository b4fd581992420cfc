"""The port's data axis without JAX: `make_mesh`, `spawn`, `shard_batch`,
`replica_seed`, and the functions that spawned ranks run for
`test_torch_port_parallel.py` and `test_torch_port_cli.py`.

The rank functions live here, in a module that imports no JAX, because
each spawned rank starts a fresh interpreter and imports the module that
holds its function.  Every spawned run has its own join timeout (`JOIN`)
and a `file://` rendezvous under the test's `tmp_path`; the ranks run on
the CPU over gloo with one thread each.
"""

import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.multiprocessing import ProcessRaisedException

from enhanced_unet_tpu_torch.config import get_preset
from enhanced_unet_tpu_torch.models import get_model
from enhanced_unet_tpu_torch.parallel import (
    make_mesh,
    replica_seed,
    shard_batch,
    spawn,
    tiled_inference_sharded,
)
from enhanced_unet_tpu_torch.train import api
from enhanced_unet_tpu_torch.train.trainer import create_train_state, make_train_step

torch.set_num_threads(1)
JOIN = 120.0          # seconds a spawned run may take


# ---- rank functions (run in the spawned processes) ------------------------

class RecordingTx:
    """A stand-in optimizer that keeps the gradients it is handed and
    changes nothing."""

    def __init__(self):
        self.grads = None

    def update(self, params, grads, state):
        self.grads = {n: g.clone() for n, g in grads.items() if g is not None}
        return state


def dp_state(state_dict, dtype=torch.float32):
    """unet_basic on the CPU in `dtype` with `state_dict`, its preset's train
    state (steps_per_epoch 2, as `tests/test_parallel.py`)."""
    cfg = get_preset("unet", num_epochs=4)
    model = get_model("unet_basic", dtype=dtype, device="cpu", seed=0).to(dtype)
    model.load_state_dict(state_dict)
    return cfg, create_train_state(model, cfg, steps_per_epoch=2, device="cpu")


def pointwise_apply(tiles):
    """The tiles' channel mean m -> logits (m, 1 - m, 0), as
    `tests/test_parallel_tiled.py`'s `_pointwise_apply`."""
    m = tiles.mean(dim=-1, keepdim=True)
    return torch.cat([m, 1.0 - m, torch.zeros_like(m)], dim=-1)


def dp_rank(mesh, inputs_path, out_dir):
    """One rank of the data-parallel step on its contiguous share of the
    global batch: the reduced gradients (handed to the optimizer),
    loss and running statistics of one step with `RecordingTx`, and the
    gradients of the same step in float64; then, from the same weights, one
    step with AdamW (parameters and statistics); and
    `tiled_inference_sharded` of each image.  Written to `rank<r>.pt`."""
    torch.set_num_threads(1)
    inputs = torch.load(inputs_path)
    images, masks, valid = shard_batch(
        (inputs["images"], inputs["masks"], inputs["valid"]), mesh)
    out = {"tiled": []}
    cfg, state = dp_state(inputs["state_dict"])
    state.tx = RecordingTx()
    step = make_train_step(cfg, mesh)
    gen = torch.Generator().manual_seed(replica_seed(1, mesh))
    _, m = step(state, images, masks, valid, gen)
    out["grads"] = state.tx.grads
    out["loss"] = m["loss"].item()
    out["stats"] = {n: b.clone() for n, b in state.model.named_buffers()
                    if n.endswith(("running_mean", "running_var"))}

    cfg, state = dp_state(inputs["state_dict"], torch.float64)
    state.tx = RecordingTx()
    step(state, images.double(), masks, valid, torch.Generator().manual_seed(1))
    out["grads64"] = state.tx.grads

    cfg, state = dp_state(inputs["state_dict"])
    gen = torch.Generator().manual_seed(replica_seed(1, mesh))
    state, m = step(state, images, masks, valid, gen)
    out["adamw_loss"] = m["loss"].item()
    out["adamw_state"] = {n: t.clone() for n, t in state.model.state_dict().items()}
    for image in inputs["tiled"]:
        out["tiled"].append(tiled_inference_sharded(pointwise_apply, image, mesh,
                                                    tile=64, overlap=16))
    torch.save(out, os.path.join(out_dir, f"rank{mesh.rank}.pt"))


def train_rank(mesh, model_name, kwargs, out_dir):
    """`train_model` as one rank of an initialised group, recording the
    checkpoints this rank writes and its model's final weights."""
    torch.set_num_threads(1)
    saved = []
    real_save = api.save_checkpoint

    def recording_save(path, state, *args):
        saved.append(os.path.basename(path))
        real_save(path, state, *args)

    api.save_checkpoint = recording_save
    real_build = api._build_state
    built = []

    def keeping_build(*args, **kw):
        built.append(real_build(*args, **kw))
        return built[-1]

    api._build_state = keeping_build
    best = api.train_model(model_name, device=mesh.device, log=print, **kwargs)
    torch.save({"saved": saved, "best": best, "state_dict": built[0].model.state_dict()},
               os.path.join(out_dir, f"train_rank{mesh.rank}.pt"))


def failing_rank(mesh):
    """Rank 1 raises; rank 0 waits for it in a collective."""
    if mesh.rank == 1:
        raise RuntimeError("rank 1 failed on purpose")
    dist.barrier()


def sleeping_rank(mesh, out_dir):
    """Writes its pid, then outlives any join timeout of the tests."""
    with open(os.path.join(out_dir, f"pid{mesh.rank}"), "w") as f:
        f.write(str(os.getpid()))
    time.sleep(600)


def slow_lead_rank(mesh, out_dir):
    """Rank 0 works past the collective timeout while rank 1 waits for it
    in `Mesh.barrier`, in a group remade with a 3 s collective timeout."""
    from datetime import timedelta

    from enhanced_unet_tpu_torch.parallel import mesh as mesh_module

    mesh.barrier()                 # both ranks remake the group together
    dist.destroy_process_group()
    mesh_module.COLLECTIVE_TIMEOUT = timedelta(seconds=3)
    again = os.path.join(out_dir, "again")
    os.makedirs(again, exist_ok=True)
    mesh = make_mesh(2, device="cpu", init_dir=again, rank=mesh.rank)
    if mesh.rank == 0:
        time.sleep(8)
    t0 = time.monotonic()
    mesh.barrier()
    with open(os.path.join(out_dir, f"waited{mesh.rank}"), "w") as f:
        f.write(str(time.monotonic() - t0))


def mean_rank(mesh, out_dir):
    """`Mesh.all_mean_` over two dtypes, and `broadcast_`."""
    x = torch.full((3,), float(mesh.rank + 1))
    y = torch.full((2, 2), float(10 * (mesh.rank + 1)), dtype=torch.float64)
    z = torch.tensor([mesh.rank + 5])
    mesh.all_mean_([x, y])
    mesh.broadcast_([z])
    torch.save({"x": x, "y": y, "z": z, "size": mesh.size, "rank": mesh.rank},
               os.path.join(out_dir, f"mean{mesh.rank}.pt"))


# ---- tests ------------------------------------------------------------------

def test_spawn_all_mean_and_broadcast(tmp_path):
    spawn(mean_rank, 2, (str(tmp_path),), device="cpu", init_dir=str(tmp_path),
          timeout=JOIN)
    for r in range(2):
        got = torch.load(tmp_path / f"mean{r}.pt")
        assert (got["rank"], got["size"]) == (r, 2)
        assert torch.equal(got["x"], torch.full((3,), 1.5))
        assert torch.equal(got["y"], torch.full((2, 2), 15.0, dtype=torch.float64))
        assert got["z"].tolist() == [5]


def test_spawn_raises_a_rank_exception_and_does_not_hang(tmp_path):
    with pytest.raises(ProcessRaisedException, match="rank 1 failed on purpose"):
        spawn(failing_rank, 2, device="cpu", init_dir=str(tmp_path), timeout=JOIN)


def test_spawn_times_out_and_ends_its_workers(tmp_path):
    with pytest.raises(TimeoutError, match="still running after 20"):
        spawn(sleeping_rank, 2, (str(tmp_path),), device="cpu", init_dir=str(tmp_path),
              timeout=20.0)
    for r in range(2):
        pid = int((tmp_path / f"pid{r}").read_text())
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_barrier_outlasts_the_collective_timeout(tmp_path):
    spawn(slow_lead_rank, 2, (str(tmp_path),), device="cpu", init_dir=str(tmp_path),
          timeout=JOIN)
    assert float((tmp_path / "waited1").read_text()) > 3.0


def test_make_mesh_raises_on_too_many_devices(tmp_path):
    mesh = make_mesh(1, device="cpu", init_dir=str(tmp_path))
    try:
        assert (mesh.rank, mesh.size, mesh.device.type) == (0, 1, "cpu")
        with pytest.raises(ValueError, match="requested 2 devices"):
            make_mesh(2, device="cpu")
        assert make_mesh(device="cpu").size == 1
    finally:
        dist.destroy_process_group()


def test_make_mesh_raises_on_too_few_cards(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="requested 2 devices, only 1 available"):
        make_mesh(2, init_dir=str(tmp_path))
    with pytest.raises(ValueError, match="requested 2 devices, only 1 available"):
        spawn(mean_rank, 2, (str(tmp_path),), init_dir=str(tmp_path), timeout=JOIN)
    assert not dist.is_initialized()


def test_make_mesh_raises_without_a_card_or_a_group(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(1, init_dir=str(tmp_path))
    for key in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(ValueError, match="no process group"):
        make_mesh(device="cpu")
    assert not dist.is_initialized()


class _Mesh:
    def __init__(self, rank, size):
        self.rank, self.size, self.device = rank, size, torch.device("cpu")


def test_shard_batch_gives_contiguous_rows():
    x = torch.arange(8 * 3).reshape(8, 3)
    y = torch.arange(8)
    for r in range(2):
        xs, ys = shard_batch((x, y), _Mesh(r, 2))
        assert torch.equal(xs, x[4 * r:4 * r + 4]) and torch.equal(ys, y[4 * r:4 * r + 4])
    with pytest.raises(ValueError, match="does not split"):
        shard_batch((y[:7],), _Mesh(0, 2))


def test_replica_seed():
    assert replica_seed(7, None) == 7
    seeds = {replica_seed(7, _Mesh(r, 4)) for r in range(4)}
    assert len(seeds) == 4
    assert replica_seed(7, _Mesh(1, 4)) == replica_seed(7, _Mesh(1, 2))


def test_train_model_spawn_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.train_model("unet_basic", str(tmp_path), num_devices=2,
                        checkpoint_dir=str(tmp_path / "ck"))
    assert not os.path.exists(tmp_path / "ck")


def test_tiled_sharded_rejects_a_wrong_class_count(tmp_path):
    mesh = make_mesh(1, device="cpu", init_dir=str(tmp_path))
    try:
        image = torch.from_numpy(np.random.default_rng(0).random((70, 80, 3), np.float32))
        with pytest.raises(ValueError, match="expected 4"):
            tiled_inference_sharded(pointwise_apply, image, mesh, tile=64, overlap=16,
                                    num_classes=4)
        with pytest.raises(ValueError, match="overlap"):
            tiled_inference_sharded(pointwise_apply, image, mesh, tile=64, overlap=64)
    finally:
        dist.destroy_process_group()
