"""Rank functions of the tensor-parallel tests
(`test_torch_port_tensor_parallel.py`, `test_torch_port_tp_train.py`,
`test_torch_port_evaluator_mesh.py`), in a module that imports no JAX:
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

`tp_train_rank` runs `make_tp_train_step` on its cases (one train state a
case, this rank's rows of the batch, a few steps) and writes what each step
left: the loss, every gradient, parameter and AdamW moment as this rank
holds it, the running statistics and the step's `COUNTS`.
`evaluator_mesh_rank` serves images through `Evaluator(mesh=...)`.
"""

import os

import torch

from spatial_ranks import port_model

from enhanced_unet_tpu_torch.ops.partition import split_of
from enhanced_unet_tpu_torch.parallel import (
    make_mesh_2d,
    make_tp_apply,
    make_tp_train_step,
    shard_params_tp,
)
from enhanced_unet_tpu_torch.parallel import tensor_parallel
from enhanced_unet_tpu_torch.train import evaluator
from enhanced_unet_tpu_torch.train.evaluator import Evaluator
from enhanced_unet_tpu_torch.train.trainer import create_train_state

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


def _snapshot(state, loss):
    """What a step left on this rank, on the host: the loss, each
    parameter, its `.grad` and moments as this rank holds them (a split
    weight's slice), and every running statistic."""
    model, opt = state.model, state.opt_state
    return {"loss": float(loss),
            "params": {n: p.detach().clone() for n, p in model.named_parameters()},
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None},
            "mu": {n: t.clone() for n, t in opt.mu.items()},
            "nu": {n: t.clone() for n, t in opt.nu.items()},
            "stats": {n: b.clone() for n, b in model.named_buffers()
                      if n.endswith(("running_mean", "running_var"))},
            "counts": dict(tensor_parallel.COUNTS)}


def tp_train_rank(mesh, grid, inputs_path, out_dir):
    """Every train case of the inputs on the `grid` = (n_data, n_model).  A
    case is (model, min_channels, cfg, images, masks, valid, seed, steps):
    `model` a model name with its state dict and kwargs (and a dtype), the
    batch whole (this rank takes its grid row's rows), `seed` the
    generator's, `steps` how many steps; each step's `_snapshot`."""
    torch.set_num_threads(1)
    inputs = torch.load(inputs_path, weights_only=False)
    mesh2 = make_mesh_2d(*grid, device="cpu")
    out = {"coords": (mesh2.data.rank, mesh2.model.rank)}
    for key, (model, min_channels, cfg, images, masks, valid, seed, steps) in inputs.items():
        name, sd, kwargs, dtype = model
        model = port_model(name, sd, dtype, **kwargs)
        shard_params_tp(model, mesh2, min_channels)
        state = create_train_state(model, cfg, steps_per_epoch=1, device="cpu")
        rows = images.shape[0] // grid[0]
        lo, hi = mesh2.data.rank * rows, (mesh2.data.rank + 1) * rows
        step = make_tp_train_step(cfg, mesh2)
        gen = torch.Generator().manual_seed(seed)
        out[key] = []
        for _ in range(steps):
            for k in tensor_parallel.COUNTS:
                tensor_parallel.COUNTS[k] = 0
            state, metrics = step(state, images[lo:hi].to(dtype), masks[lo:hi], valid[lo:hi],
                                  gen)
            out[key].append(_snapshot(state, metrics["loss"]))
    torch.save(out, os.path.join(out_dir, f"out{mesh.rank}.pt"))


def evaluator_mesh_rank(mesh, inputs_path, out_dir):
    """`Evaluator(..., mesh=mesh)` on the inputs' model: for each tiled case
    (tile_batch, image) the probabilities of `predict_probs_tiled` and the
    mask of `predict_semantic_mask`, with the sizes of the tile shares this
    rank forwarded, the enhancement replaced by the inputs' enhanced image
    (the JAX Evaluator's, whose CLAHE differs from the port's by a few grey
    levels); then, enhancing as the port does, `evaluate` on the inputs'
    loader batches with the mesh and without it."""
    torch.set_num_threads(1)
    inputs = torch.load(inputs_path, weights_only=False)
    name, sd, kwargs = inputs["model"]
    model = port_model(name, sd, **kwargs)
    settings = dict(device="cpu", tiled=True, tile=inputs["tile"], overlap=inputs["overlap"],
                    verbose=False)
    own = evaluator.eval_preprocess
    out = {}
    for key, (tile_batch, image, enhanced) in inputs["tiled"].items():
        evaluator.eval_preprocess = lambda x, e=enhanced: torch.from_numpy(e * 255.0)
        try:
            ev = Evaluator(model, name, tile_batch=tile_batch, mesh=mesh, **settings)
            shares = []
            tile_probs = ev._tile_probs
            ev._tile_probs = lambda t: shares.append(t.shape[0]) or tile_probs(t)
            out[key] = {"probs": ev.predict_probs_tiled(image),
                        "mask": ev.predict_semantic_mask(image), "shares": shares}
        finally:
            evaluator.eval_preprocess = own
    out["evaluate"] = {k: Evaluator(model, name, mesh=m, **settings).evaluate(inputs["loader"])
                       for k, m in (("mesh", mesh), ("none", None))}
    torch.save(out, os.path.join(out_dir, f"eval{mesh.rank}.pt"))
