"""Data-parallel training, ported from
`enhanced_unet_tpu/parallel/data_parallel.py`.

Every process holds the whole train state and its own slice of the batch;
after its backward, one all-reduce averages the gradients, the loss and the
BatchNorm running statistics, so the replicas stay bit-identical, as the
JAX step's `pmean` over `Mesh('data')` does (`train.trainer.make_train_step`
with a mesh).  Per-step normalisation stays per replica: the reference's
unsynchronised BatchNorm at batch 2 (train_eval.py:1059).  The reductions
are explicit; `DistributedDataParallel` is not used, since it would copy
rank 0's running statistics over the others' instead of averaging them, and
would refuse a parameter that never gets a gradient (the UNet++ head
block's `attention1`).

`make_global_batch` has no counterpart: in the JAX package one process
feeds all its chips and assembles a global array, while here each process
already holds only its local batch, which it takes from
`BatchLoader(process_shard=(rank, size))`.  `shard_batch` keeps the JAX
package's single-process placement (contiguous rows per replica) for the
parity tests.
"""

from __future__ import annotations

import dataclasses
import math
import os
import pickle
import tempfile
import time
from typing import Any, Callable, Optional, Sequence, Union

import numpy as np
import torch
import torch.multiprocessing as mp

from enhanced_unet_tpu_torch.config import TrainConfig
from enhanced_unet_tpu_torch.device import resolve_device
from enhanced_unet_tpu_torch.parallel.mesh import Mesh, make_mesh
from enhanced_unet_tpu_torch.train.trainer import TrainState, make_train_step


def make_dp_train_step(cfg: TrainConfig, mesh: Mesh):
    """The train step of one replica: `make_train_step(cfg, mesh)`.  Call it
    on every rank with the replicated state and this rank's batch; the loss
    it returns is already the mean over the ranks."""
    return make_train_step(cfg, mesh)


def replicate_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Rank 0's train state on every rank: parameters, buffers, the AdamW
    moments and the counts broadcast from rank 0 (after a resume, so that
    the replicas start identical)."""
    model = state.model
    opt = state.opt_state
    tensors = [*model.parameters(), *model.buffers(), *opt.mu.values(), *opt.nu.values()]
    counts = torch.tensor([state.step, opt.count], dtype=torch.int64, device=mesh.device)
    mesh.broadcast_(tensors + [counts])
    step, count = counts.tolist()
    return dataclasses.replace(state, step=step, opt_state=dataclasses.replace(opt, count=count))


def shard_batch(global_leaves: Sequence[torch.Tensor], mesh: Mesh):
    """This rank's contiguous rows `[r*B:(r+1)*B]` of each [size*B, ...]
    leaf, on the rank's device."""
    out = []
    for x in global_leaves:
        if x.shape[0] % mesh.size:
            raise ValueError(f"batch of {x.shape[0]} does not split over {mesh.size} ranks")
        b = x.shape[0] // mesh.size
        out.append(x[mesh.rank * b:(mesh.rank + 1) * b].to(mesh.device))
    return tuple(out)


def replica_seed(seed: int, mesh: Optional[Mesh]) -> int:
    """The seed of this replica's dropout and stochastic-depth generator:
    `seed` without a mesh, else one drawn from (seed, rank), so that the
    replicas draw different masks, as the JAX step folds the replica's
    index into its key (`enhanced_unet_tpu/train/trainer.py:115-118`)."""
    if mesh is None:
        return seed
    return int(np.random.SeedSequence([seed, mesh.rank]).generate_state(1)[0])


def _worker(rank: int, fn: Callable, n: int, args: tuple, device: Optional[str],
            init_dir: str, backend: Optional[str]) -> None:
    mesh = make_mesh(n, device=device, init_dir=init_dir, rank=rank, backend=backend)
    try:
        fn(mesh, *args)
    finally:
        torch.distributed.destroy_process_group()


def spawn(fn: Callable[..., Any], n: int, args: tuple = (), *,
          device: Optional[Union[str, torch.device]] = None, backend: Optional[str] = None,
          init_dir: Optional[str] = None, timeout: Optional[float] = None) -> None:
    """Run `fn(mesh, *args)` in `n` new processes, one per rank of a new
    process group, and wait for all of them.  `device` None (or `"cuda"`)
    puts rank r on the card `cuda:r` (NCCL); another device given
    (`"cpu"`: gloo) is every rank's.  `fn` and `args` are pickled: `fn`
    must be a module's function.  The rendezvous is a `file://` store in
    `init_dir` (default: a temporary directory).  A worker's exception
    ends the others and is raised here (`ProcessRaisedException`, with the
    traceback of every rank that raised); so does a worker that exits
    otherwise, and `timeout` seconds (None: no limit, as a training run
    needs) without every worker done raise `TimeoutError`."""
    if device is not None and torch.device(device) == torch.device("cuda"):
        device = None
    if device is None:
        resolve_device(None)
        if n > torch.cuda.device_count():
            raise ValueError(f"requested {n} devices, only {torch.cuda.device_count()} "
                             "available")
    device = None if device is None else str(device)
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_worker, args=(fn, n, args, device, init_dir or tmp, backend),
                                 nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + (math.inf if timeout is None else timeout)
        try:
            while not ctx.join(timeout=min(1.0, max(deadline - time.monotonic(), 0.0))):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{n} workers of {fn.__name__} still running after "
                                       f"{timeout} s")
        except mp.ProcessRaisedException as err:
            # every rank's error, not only the first one the join found: a
            # rank that fails makes its peers' collectives fail too
            traces = []
            for rank, path in enumerate(ctx.error_files):
                if os.access(path, os.R_OK):
                    with open(path, "rb") as fh:
                        traces.append(f"\n-- rank {rank}:\n{pickle.load(fh)}")
            raise mp.ProcessRaisedException("".join(traces), err.error_index,
                                            err.error_pid) from None
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
