"""Rank functions of the spatial-partitioning tests
(`test_torch_port_spatial*.py`), in a module that imports no JAX: each
spawned rank starts a fresh interpreter and imports the module that holds
its function.  The ranks run on the CPU over gloo with one thread each.

Every function reads its inputs from one `torch.save` file, computes this
rank's band of each result with `parallel/spatial.py`, gathers the whole
result on every rank and writes rank 0's to `out<rank>.pt` (the bands as
each rank holds them too, where a test reads them).
"""

import os

import torch

from enhanced_unet_tpu_torch.models import get_model
from enhanced_unet_tpu_torch.parallel.spatial import (
    gather_image_h,
    halo_exchange,
    make_spatial_apply,
    make_spatial_basic_unet,
    make_spatial_conv3x3,
    shard_image_h,
)

torch.set_num_threads(1)
JOIN = 300.0          # seconds a spawned run may take


def port_model(name, state_dict=None, **kwargs):
    """`get_model(name)` on the CPU in fp32, with `state_dict` if given."""
    model = get_model(name, dtype=torch.float32, device="cpu", seed=7, **kwargs)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return model


def _apply(mesh, model, x):
    """make_spatial_apply of one image [1, H, W, 3]: this rank's band in,
    the whole logits out."""
    y = make_spatial_apply(model, mesh)(shard_image_h(x[0], mesh)[None])
    return gather_image_h(y[0], mesh)[None]


def halo_rank(mesh, x, halo, out_dir):
    """Each rank's haloed band of x [H, W, C] in both modes."""
    torch.set_num_threads(1)
    band = shard_image_h(x, mesh)
    out = {mode: halo_exchange(band, halo, mesh, mode) for mode in ("zero", "edge")}
    torch.save(out, os.path.join(out_dir, f"halo{mesh.rank}.pt"))


def spatial_rank(mesh, inputs_path, out_dir):
    """`make_spatial_conv3x3`, `make_spatial_basic_unet` and
    `make_spatial_apply` on the inputs' cases, and the errors of a band
    that does not split."""
    torch.set_num_threads(1)
    inputs = torch.load(inputs_path)
    out = {}
    x, w = inputs["conv"]
    y = make_spatial_conv3x3(mesh)(shard_image_h(x, mesh), w)
    out["conv"] = gather_image_h(y, mesh)

    sd, x = inputs["basic_unet"]
    model = port_model("unet_basic", sd)
    y = make_spatial_basic_unet(mesh)(model, shard_image_h(x, mesh))
    out["basic_unet"] = gather_image_h(y, mesh)

    for key, (name, sd, kwargs, x) in inputs["apply"].items():
        out[key] = _apply(mesh, port_model(name, sd, **kwargs), x)

    name, x = inputs["no_split"]
    try:
        _apply(mesh, port_model(name), x)
        out["no_split"] = None
    except ValueError as err:
        out["no_split"] = str(err)
    torch.save(out, os.path.join(out_dir, f"out{mesh.rank}.pt"))


def apply_rank(mesh, inputs_path, out_dir):
    """`make_spatial_apply` of each case of the inputs: (model name, its
    state dict, its kwargs, x)."""
    torch.set_num_threads(1)
    inputs = torch.load(inputs_path)
    out = {key: _apply(mesh, port_model(name, sd, **kwargs), x)
           for key, (name, sd, kwargs, x) in inputs.items()}
    torch.save(out, os.path.join(out_dir, f"out{mesh.rank}.pt"))
