"""The 1-D data axis, ported from `enhanced_unet_tpu/parallel/mesh.py`.

The JAX package runs one process over N chips and builds a `Mesh('data')`
of them.  PyTorch runs one process per device: the counterpart of the mesh
is the process group, with this process's rank and its device.  On a card
the group is NCCL over `cuda:<local rank>`; on the CPU it is gloo.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import List, Optional, Union

import torch
import torch.distributed as dist

from enhanced_unet_tpu_torch.device import resolve_device

# how long a collective waits for a peer before it raises (a rank that
# died must fail its peers, not hang them)
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)
# how long `Mesh.barrier` waits: the other ranks wait there while rank 0
# alone evaluates (the gate, the CLI's evaluation) or writes a checkpoint,
# which may take longer than a collective's timeout.  A peer that dies still
# fails the barrier at once: its gloo connection closes.
BARRIER_TIMEOUT = datetime.timedelta(days=7)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A process group seen from one of its processes: `size` processes,
    this one `rank`, computing on `device`; `barrier_group` is a gloo group
    of the same processes with BARRIER_TIMEOUT."""

    group: object
    rank: int
    size: int
    device: torch.device
    barrier_group: object
    axis_name: str = "data"

    @torch.no_grad()
    def all_mean_(self, tensors: List[torch.Tensor]) -> None:
        """Replace each tensor by its mean over the group, in place: one SUM
        all-reduce of the tensors flattened together (per dtype), then a
        divide by `size` (gloo has no AVG).  Every rank must pass tensors of
        the same shapes in the same order."""
        by_dtype = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for group in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
            flat.div_(self.size)
            # back in a few multi-tensor launches, not one copy per tensor
            parts = flat.split([t.numel() for t in group])
            torch._foreach_copy_(group, [p.view_as(t) for p, t in zip(parts, group)])

    @torch.no_grad()
    def broadcast_(self, tensors: List[torch.Tensor]) -> None:
        """Overwrite each tensor with the group's rank 0's, in place."""
        src = dist.get_global_rank(self.group, 0)
        for t in tensors:
            dist.broadcast(t, src=src, group=self.group)

    def barrier(self) -> None:
        """Wait until every rank is here, for up to BARRIER_TIMEOUT."""
        dist.barrier(group=self.barrier_group)


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data", *,
              device: Optional[Union[str, torch.device]] = None,
              init_dir: Optional[str] = None, rank: int = 0,
              backend: Optional[str] = None) -> Mesh:
    """The data axis over `n_devices` processes (default: all of the group).

    With a process group already initialised, its processes; else one is
    initialised: through a `file://` store in `init_dir` as `rank` of
    `n_devices` (default 1), or without `init_dir` from `torchrun`'s
    environment (`env://`).  `device` None (or `"cuda"`) is the card
    `cuda:<local rank>` (`LOCAL_RANK`, else the rank), raising without one;
    any other device is taken as it is.  The backend is NCCL
    on a card and gloo on the CPU unless `backend` says otherwise.  Raises
    `ValueError` when `n_devices` is not the group's size (one process per
    device) or the host has fewer cards than processes."""
    if dist.is_initialized():
        size, rank = dist.get_world_size(), dist.get_rank()
    elif init_dir is not None:
        size = 1 if n_devices is None else n_devices
    elif "WORLD_SIZE" in os.environ:
        size, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        raise ValueError("no process group: pass init_dir, or run under torchrun")
    if n_devices is not None and n_devices != size:
        raise ValueError(f"requested {n_devices} devices, the process group has {size} "
                         "processes (one process per device)")
    if device is None or torch.device(device) == torch.device("cuda"):
        resolve_device(None)
        local_size = int(os.environ.get("LOCAL_WORLD_SIZE", size))
        if local_size > torch.cuda.device_count():
            raise ValueError(f"requested {local_size} devices, only "
                             f"{torch.cuda.device_count()} available")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    else:
        dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        init_method = (f"file://{os.path.join(os.path.abspath(init_dir), 'rendezvous')}"
                       if init_dir is not None else "env://")
        dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                                init_method=init_method, rank=rank, world_size=size,
                                timeout=COLLECTIVE_TIMEOUT)
    # collective: every rank makes its mesh at the same point
    barrier_group = dist.new_group(backend="gloo", timeout=BARRIER_TIMEOUT)
    return Mesh(group=dist.group.WORLD, rank=rank, size=size, device=dev,
                barrier_group=barrier_group, axis_name=axis_name)


# ---- transport: what the spatial and tensor-parallel axes send ------------
# NCCL carries device tensors between cards; gloo (the CPU, or ranks sharing
# one card) takes host tensors only, so a CUDA tensor goes through host
# memory there while the compute stays on the device.


def is_gloo(mesh: Mesh) -> bool:
    return dist.get_backend(mesh.group) == "gloo"


def wire(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """t as the transport takes it: contiguous, in host memory under gloo."""
    t = t.contiguous()
    return t.cpu() if t.is_cuda and is_gloo(mesh) else t


def gather(mesh: Mesh, x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every rank's equal part of x concatenated along `dim` in rank order
    (an all-gather), on x's device."""
    if mesh.size == 1:
        return x
    part = wire(mesh, x)
    parts = [torch.empty_like(part) for _ in range(mesh.size)]
    dist.all_gather(parts, part, group=mesh.group)
    return torch.cat(parts, dim).to(x.device)


def all_sum_(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """t summed over the ranks, in place."""
    if mesh.size > 1:
        w = wire(mesh, t)
        dist.all_reduce(w, op=dist.ReduceOp.SUM, group=mesh.group)
        if w is not t:
            t.copy_(w)
    return t
