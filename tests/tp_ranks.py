"""Rank functions of the tensor-parallel tests
(`test_torch_port_tensor_parallel.py`), in a module that imports no JAX:
each spawned rank starts a fresh interpreter and imports the module that
holds its function.  The ranks run on the CPU over gloo with one thread
each.

`tp_rank` reads its cases from one `torch.save` file, makes the grid once,
and for each case builds the port's model on the case's weights, shards it
with `shard_params_tp`, runs `make_tp_apply` on this rank's rows of the
batch and writes what it got to `out<rank>.pt`: the logits, the forward's
`COUNTS`, and the shape of every weight the rank holds split; then what the
grid's two axes give as `Mesh`es (their rank and size, a broadcast from
their rank 0, a mean, a barrier).
"""

import os

import torch

from spatial_ranks import port_model

from enhanced_unet_tpu_torch.ops.partition import split_of
from enhanced_unet_tpu_torch.parallel import make_mesh_2d, make_tp_apply, shard_params_tp
from enhanced_unet_tpu_torch.parallel import tensor_parallel

torch.set_num_threads(1)


def tp_rank(mesh, grid, inputs_path, out_dir):
    """Every case of the inputs on the `grid` = (n_data, n_model) of the
    spawned ranks.  A case is (model, min_channels, x): `model` a model
    name with its state dict and kwargs, or a module itself."""
    torch.set_num_threads(1)
    inputs = torch.load(inputs_path, weights_only=False)
    mesh2 = make_mesh_2d(*grid, device="cpu")
    out = {"coords": (mesh2.data.rank, mesh2.model.rank)}
    for key, (model, min_channels, x) in inputs.items():
        if isinstance(model, tuple):
            name, sd, kwargs = model
            model = port_model(name, sd, **kwargs)
        shard_params_tp(model.eval(), mesh2, min_channels)
        rows = x.shape[0] // grid[0]
        x_local = x[mesh2.data.rank * rows:(mesh2.data.rank + 1) * rows]
        for k in tensor_parallel.COUNTS:
            tensor_parallel.COUNTS[k] = 0
        with torch.no_grad():
            y = make_tp_apply(model, mesh2)(x_local)
        out[key] = {"logits": y, "counts": dict(tensor_parallel.COUNTS),
                    "split": {n: tuple(p.shape) for n, p in model.named_parameters()
                              if split_of(p) is not None}}
    # the grid's axes as `Mesh`es: rank 0 of each broadcasts its global
    # rank, each averages the global ranks, each waits at its barrier
    for name in ("data", "model"):
        axis = getattr(mesh2, name)
        first, mean = torch.tensor([float(mesh.rank)]), torch.tensor([float(mesh.rank)])
        axis.broadcast_([first])
        axis.all_mean_([mean])
        axis.barrier()
        out[name] = (axis.rank, axis.size, first.item(), mean.item())
    torch.save(out, os.path.join(out_dir, f"out{mesh.rank}.pt"))
