"""Tensor parallelism, ported from
`enhanced_unet_tpu/parallel/tensor_parallel.py` (`make_mesh_2d`,
`tp_param_specs`, `shard_params_tp`, `make_tp_apply`, `make_tp_train_step`).

The JAX package lays its devices out on a 2-D `Mesh(('data', 'model'))`,
annotates the wide conv kernels with a channel sharding and lets XLA derive
every collective (GSPMD).  Here each process is one rank of an `n_data` x
`n_model` grid: the batch rides the data axis (each rank gets its rows of
it), the channels of the wide conv weights the model axis, and
`TensorParallelMode`, a `TorchFunctionMode`, rewrites each PyTorch call of
the model's own forward that meets a channel slice, with the collectives
written out (Megatron's pattern):

- a conv weight with Cout >= `min_channels` keeps Cout / n_model output
  channels on each rank (the "column" split; an `nn.ConvTranspose2d`'s
  Cout is its dim 1); the conv of a block's second ConvBNAct
  (`models.blocks.row_split`, the JAX package's `ConvBNAct_1`) with Cin >=
  `min_channels` keeps Cin / n_model input channels instead (the "row"
  split); every other tensor is whole on every rank;
- a column-split conv takes a whole input (a slice is all-gathered first)
  and gives this rank's slice of its output channels, its bias cut with
  them; a depthwise conv split on the same channels takes the slice;
- a row-split conv takes its input's slice of its input channels (a whole
  input is cut, a slice of other channels gathered and cut), sums its
  partial output over the model axis in fp32 (one all-reduce) and adds its
  bias once, after the sum;
- channel-local operations keep the slice: BN in eval mode (statistics and
  affine cut to the slice), activations, casts and layouts, pads, pools
  and resizes, reductions over other dims than N and C, reshapes, permutes,
  expands and indexing that keep N and C in place, and element-wise
  operations whose other operands carry the same slice, broadcast along C
  or are whole (then cut to the slice, which costs nothing);
- every other operation that meets a slice all-gathers it first over the
  model axis, once per slice (a skip read twice is gathered once): always
  right.  An in-place operation on a slice that no rule keeps local
  raises, as does any operation on a split weight but a cast, and BN in
  train mode called other than through `models.blocks.batch_norm`.

So a column-split conv whose output reaches a row-split conv through
channel-local operations costs one all-reduce and no all-gather (a
DoubleConv pair, the fusion head's 256 -> 128).  K2 and K1, which the mode
cannot see, ask it through `ops.partition`: K2 runs on a column slice with
the BN folded on the same slice, and on a row slice with scale 1, shift 0
and no ReLU, then the sum, then BN and ReLU; a K1 block with a split
weight gathers its weights whole for the call, their storage staying
sharded.

The train step (`make_tp_train_step`) is the JAX step's one program over
the whole batch, spelled out rank by rank.  Every collective of the
forward is an autograd function with its backward (Megatron's f and g):
an all-gather's is this rank's slice of the gradient; a whole tensor that
rank-specific work consumes (a column split's input, an operand broadcast
against a slice) has its gradient summed over the model axis; a row
split's all-reduce passes its gradient on unchanged; a whole tensor cut to
a slice (an input, a bias, a BN weight) gets the slices' gradients
all-gathered, so that a replicated parameter's gradient is whole and equal
on every rank and counted once.  BatchNorm takes the whole batch's
statistics (each rank's per-channel count, mean and squared deviations
all-gathered over the data axis and combined; the backward all-reduces)
and the running statistics of a slice are all-gathered after the forward;
dropout and stochastic depth draw over the whole batch and keep this
rank's part; the loss is the whole batch's; the gradients are summed over
the data axis, the whole parameters' broadcast from model rank 0 (a card's
kernels may round differently on each replica), and all clipped by their
global norm (a split weight's shards counted once).  `COUNTS` counts the
collectives and K2's calls by kind.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from enhanced_unet_tpu_torch.config import TrainConfig
from enhanced_unet_tpu_torch.models.blocks import packed_conv3x3
from enhanced_unet_tpu_torch.ops import partition
from enhanced_unet_tpu_torch.ops.losses import combined_loss_with_aux
from enhanced_unet_tpu_torch.ops.partition import Split, split_of
from enhanced_unet_tpu_torch.ops.kernels.conv_fused import fold_bn_params
from enhanced_unet_tpu_torch.parallel.mesh import (
    BARRIER_TIMEOUT,
    COLLECTIVE_TIMEOUT,
    Mesh,
    all_sum_,
    gather,
    make_mesh,
    wire,
)
from enhanced_unet_tpu_torch.parallel.torch_function import (
    call_args,
    func_name,
    replace_tensors,
    tensors_of,
)
from enhanced_unet_tpu_torch.train.trainer import TrainState

# what a tensor-parallel forward or train step did, counted from 0 by
# whoever reads it: collectives over the model axis in the forward and the
# step (a weight gathered whole for K1, the running statistics' gather, the
# replicas' broadcast and the gradient norm's all-reduce included), those of
# the backward, those over the data axis (BatchNorm's statistics gathered in
# the forward and reduced in the backward, the loss's counts, the
# gradients), K2's calls on whole weights, column and row slices, and K1's
# calls with weights gathered whole
COUNTS = {"all_gather": 0, "all_reduce": 0, "broadcast": 0, "grad_all_gather": 0,
          "grad_all_reduce": 0, "data_all_gather": 0, "data_all_reduce": 0, "k2_whole": 0,
          "k2_column": 0, "k2_row": 0, "k1_gathered": 0}


# ---- the grid ---------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """An `n_data` x `n_model` grid of processes seen from one of them:
    `data` is its column of the grid (the ranks with its model index),
    `model` its row (the ranks with its data index), each a `Mesh` with its
    own rank and size; `world` holds every rank.  Global rank r sits at
    (r // n_model, r % n_model)."""

    data: Mesh
    model: Mesh
    world: Mesh
    shape: Tuple[int, int]

    @property
    def device(self) -> torch.device:
        return self.world.device


def make_mesh_2d(n_data: int, n_model: int,
                 axis_names: Tuple[str, str] = ("data", "model"), *,
                 device: Optional[Union[str, torch.device]] = None,
                 init_dir: Optional[str] = None, rank: int = 0,
                 backend: Optional[str] = None) -> Mesh2D:
    """The grid over `n_data * n_model` processes, one per device, as
    `make_mesh` makes its axis (a process group already initialised, else
    one from `init_dir` or `torchrun`'s environment; NCCL on the cards,
    gloo on the CPU; `device` None is the card `cuda:<local rank>`,
    raising without one).  Raises `ValueError` when `n_data * n_model` is
    not the group's size or the host has fewer cards than processes."""
    world = make_mesh(n_data * n_model, axis_names[0], device=device, init_dir=init_dir,
                      rank=rank, backend=backend)
    rows = [list(range(i * n_model, (i + 1) * n_model)) for i in range(n_data)]
    cols = [list(range(j, n_data * n_model, n_model)) for j in range(n_model)]
    axes = {}
    # `new_group` is collective: every rank makes every group, its own or
    # not, in the same order
    for name, groups in ((axis_names[1], rows), (axis_names[0], cols)):
        for ranks in groups:
            group = dist.new_group(ranks, timeout=COLLECTIVE_TIMEOUT)
            barrier = dist.new_group(ranks, backend="gloo", timeout=BARRIER_TIMEOUT)
            if world.rank in ranks:
                axes[name] = Mesh(group=group, rank=ranks.index(world.rank), size=len(ranks),
                                  device=world.device, barrier_group=barrier, axis_name=name)
    return Mesh2D(data=axes[axis_names[0]], model=axes[axis_names[1]], world=world,
                  shape=(n_data, n_model))


# ---- the splits -------------------------------------------------------------


def _rule(m: nn.Module, min_channels: int) -> Optional[Tuple[str, int]]:
    """(kind, dim) of the split of `m.weight`, or None (JAX's
    `tp_param_specs` on a flax kernel [kh, kw, Cin / groups, Cout])."""
    if isinstance(m, nn.ConvTranspose2d):         # [Cin, Cout, kh, kw]
        return ("column", 1) if m.out_channels >= min_channels else None
    if isinstance(m, nn.Conv2d):                  # [Cout, Cin / groups, kh, kw]
        if getattr(m, "tp_row_split", False) and m.in_channels // m.groups >= min_channels:
            return "row", 1
        if m.out_channels >= min_channels:
            return "column", 0
    return None


def tp_param_specs(model: nn.Module, min_channels: int = 128) -> Dict[str, Optional[int]]:
    """For each name of `model.state_dict()`, the dim of the tensor that
    tensor parallelism splits over the model axis, or None (whole on every
    rank): an `nn.Conv2d` weight's output channels (dim 0; a depthwise
    weight's too) where Cout >= `min_channels`, its input channels (dim 1)
    where it is a `row_split` conv with Cin >= `min_channels`; an
    `nn.ConvTranspose2d` weight's output channels (dim 1).  Biases, BN
    parameters and statistics, and narrow kernels are None."""
    specs = dict.fromkeys(model.state_dict())
    for name, m in model.named_modules():
        rule = _rule(m, min_channels)
        if rule is not None:
            specs[f"{name}.weight" if name else "weight"] = rule[1]
    return specs


def shard_params_tp(model: nn.Module, mesh: Mesh2D, min_channels: int = 128) -> nn.Module:
    """Keep on this rank only its slice of every weight `tp_param_specs`
    splits: slice `mesh.model.rank` of `mesh.model.size` along the split
    dim.  Each such `nn.Parameter` is replaced (the whole tensor is freed)
    by one that records its `ops.partition.Split` (kind, dim, slice, full
    width); everything else stays whole.  Load the whole state dict first,
    then shard.  Raises `ValueError`, naming the parameter, where a split
    dim does not divide by the model axis's size.  Returns `model`."""
    n, r = mesh.model.size, mesh.model.rank
    plan = []
    for name, m in model.named_modules():
        rule = _rule(m, min_channels)
        if rule is None:
            continue
        kind, dim = rule
        if split_of(m.weight) is not None:
            raise ValueError(f"{name}.weight is sharded already")
        full = m.weight.shape[dim]
        if full % n:
            raise ValueError(f"{name}.weight: {full} channels along dim {dim} do not split "
                             f"over {n} ranks of the model axis")
        plan.append((m, Split(kind, dim, r * full // n, (r + 1) * full // n, full)))
    with torch.no_grad():
        for m, split in plan:
            w = m.weight
            p = nn.Parameter(w.narrow(split.dim, split.lo, split.hi - split.lo).clone(),
                             requires_grad=w.requires_grad)
            setattr(p, partition.SPLIT, split)
            m.weight = p
    for m in model.modules():       # the packs and folds of the whole weights
        for cache in ("_packed_conv3x3", "_folded", "_dw_folded"):
            m.__dict__.pop(cache, None)
    return model


def make_tp_apply(model: nn.Module, mesh: Mesh2D) -> Callable[[torch.Tensor], torch.Tensor]:
    """`fn(x_local [N_local, H, W, 3]) -> logits [N_local, H, W, C]` (fp32):
    the model's own forward in eval mode on this rank's rows of the batch,
    under `TensorParallelMode` over `mesh.model`, its weights as
    `shard_params_tp` left them; equal to the unsharded `model(x_local)[0]`.
    The ranks of one row of the grid get the same rows of the batch.  Raises
    `ValueError` in train mode, and `RuntimeError` where grad mode is on and
    a parameter requires grad (eval mode runs K2 and K1, which have no
    backward: `make_tp_train_step` trains)."""

    def fwd(x_local: torch.Tensor) -> torch.Tensor:
        if model.training:
            raise ValueError("tensor parallelism's forward runs a model in eval mode")
        if torch.is_grad_enabled() and any(p.requires_grad for p in model.parameters()):
            raise RuntimeError("make_tp_apply: tensor parallelism's forward has no backward; "
                               "run it under torch.no_grad()/torch.inference_mode()")
        mode = TensorParallelMode(mesh.model)
        with torch.no_grad(), mode:
            out = model(x_local.to(mesh.device))
            out = out[0] if isinstance(out, tuple) else out
        return mode.whole_tensor(out)

    return fwd


def _flat_(mesh: Mesh, tensors, collective) -> None:
    """`collective(mesh, flat)` (in place) on the tensors flattened
    together, per dtype, and the result copied back into them."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = collective(mesh, torch.cat([t.reshape(-1) for t in group]))
        parts = flat.split([t.numel() for t in group])
        torch._foreach_copy_(group, [q.view_as(t) for q, t in zip(parts, group)])


def _broadcast_(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """t overwritten with the rank 0 of `mesh`'s, in place (staged as the
    transport stages it)."""
    if mesh.size > 1:
        w = wire(mesh, t)
        dist.broadcast(w, src=dist.get_global_rank(mesh.group, 0), group=mesh.group)
        if w is not t:
            t.copy_(w)
    return t


def make_tp_train_step(cfg: TrainConfig, mesh: Mesh2D):
    """`step(state, images_local, masks_local, valid_local, generator) ->
    (state, {"loss": ...})`: one train step of the whole batch over the grid
    `mesh`, the JAX package's one GSPMD program rank by rank.  Each rank
    passes its grid row's rows of the batch (equal shares; the ranks of a
    row the same rows) and a generator seeded alike on every rank; `state`
    comes from `create_train_state` on a model that `shard_params_tp` has
    split, so AdamW's moments keep the shards' shapes.

    The model's train-mode forward runs under `TensorParallelMode` over
    `mesh.model`, with BatchNorm's statistics, dropout's and stochastic
    depth's draws over the whole batch (`mesh.data`); the loss is the
    whole batch's `combined_loss_with_aux` (the focal term's sums and count
    over the whole batch, the per-image means averaged over the shards);
    the backward's gradients are summed over `mesh.data`, clipped by their
    global norm (each split weight's shards counted once) and AdamW updates
    this rank's parameters.  Every rank returns the whole batch's loss;
    afterwards every whole parameter, its `.grad` (clipped) and moments and
    every running statistic are the same on every rank, each split weight
    and its `.grad` and moments this rank's slice of the one-process
    step's."""
    loss_cfg = cfg.loss

    def tp_step(state: TrainState, images: torch.Tensor, masks: torch.Tensor,
                valid: torch.Tensor, generator: Optional[torch.Generator]):
        model = state.model.train()
        model.zero_grad(set_to_none=True)
        n_data = mesh.data.size
        # the whole batch's valid pixels and images
        counts = torch.tensor([float(valid.sum()), images.shape[0]], dtype=torch.float64,
                              device=mesh.device)
        all_sum_(mesh.data, counts)
        COUNTS["data_all_reduce"] += 1
        if counts[1].item() != images.shape[0] * n_data:
            raise ValueError(f"tensor parallelism's train step takes equal shares of the batch: "
                             f"{images.shape[0]} rows here, {int(counts[1].item())} in all over "
                             f"{n_data} ranks")
        mode = TensorParallelMode(mesh.model, data=mesh.data)
        with mode:
            logits, aux = model(images, generator=generator)
            logits = mode.whole_tensor(logits)
            aux = {k: mode.whole_tensor(v) for k, v in aux.items()}
        mode.sync_running_stats()
        # this shard's share of the whole batch's loss: the focal sums over
        # the whole batch's valid pixels, the per-image means over n_data
        focal_norm = (counts[0].clamp_min(1.0) / n_data).to(torch.float32)
        loss = combined_loss_with_aux(logits, aux, masks, loss_cfg, valid,
                                      focal_norm=focal_norm) / n_data
        loss.backward()
        loss = loss.detach()
        params = dict(model.named_parameters())
        whole = [p.grad for p in params.values() if p.grad is not None and split_of(p) is None]
        split = [p.grad for p in params.values() if p.grad is not None and split_of(p)]
        _flat_(mesh.data, whole + split + [loss], all_sum_)
        COUNTS["data_all_reduce"] += 1
        if mesh.model.size > 1:
            # the replicas of a whole parameter compute its gradient alike,
            # but a card's kernels may add in another order on each (cuDNN's
            # weight gradients use atomics): model rank 0's gradients and
            # running statistics go to the others, so the replicas stay equal
            _flat_(mesh.model, whole + [b for n, b in model.named_buffers()
                                        if n.endswith(("running_mean", "running_var"))],
                   _broadcast_)
            COUNTS["broadcast"] += 1

        def squares(gs):
            return torch.stack(torch._foreach_norm(gs)).double().square().sum() if gs else \
                torch.zeros((), dtype=torch.float64, device=mesh.device)

        # the global norm: each split weight's shards summed over the model
        # axis, each whole parameter counted once
        split_squares = all_sum_(mesh.model, squares(split))
        COUNTS["all_reduce"] += 1
        norm = (squares(whole) + split_squares).sqrt().to(whole[0].dtype)
        opt_state = state.tx.update(params, {n: p.grad for n, p in params.items()},
                                    state.opt_state, norm=norm)
        return (dataclasses.replace(state, step=state.step + 1, opt_state=opt_state),
                {"loss": loss})

    return tp_step


# ---- the collectives' backward ------------------------------------------------


class _Gather(torch.autograd.Function):
    """A channel slice all-gathered whole along `dim` over `mesh`; backward:
    this rank's slice of the whole tensor's gradient (equal on every rank)."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh, dim: int):
        ctx.mesh, ctx.dim = mesh, dim
        return gather(mesh, x, dim)

    @staticmethod
    def backward(ctx, g):
        k = g.shape[ctx.dim] // ctx.mesh.size
        return g.narrow(ctx.dim, ctx.mesh.rank * k, k), None, None


class _Cut(torch.autograd.Function):
    """A whole tensor cut to this rank's slice [lo, hi) along `dim`;
    backward: the slices' gradients all-gathered over `mesh`, the whole
    tensor's gradient on every rank."""

    @staticmethod
    def forward(ctx, t, mesh: Mesh, dim: int, lo: int, hi: int):
        ctx.mesh, ctx.dim = mesh, dim
        return t.narrow(dim, lo, hi - lo)

    @staticmethod
    def backward(ctx, g):
        COUNTS["grad_all_gather"] += 1
        return gather(ctx.mesh, g, ctx.dim), None, None, None, None


class _Sum(torch.autograd.Function):
    """Megatron's g: t summed over `mesh`; backward: the gradient passed on
    (the sum is used alike on every rank, as a row split's)."""

    @staticmethod
    def forward(ctx, t, mesh: Mesh):
        # t's layout kept (a channels_last map stays one: dropout draws in
        # its input's memory order)
        return all_sum_(mesh, t.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Replicated(torch.autograd.Function):
    """Megatron's f: a whole tensor that rank-specific work consumes (a
    column split's input, an operand broadcast against a slice) as it is;
    backward: its gradient summed over `mesh`."""

    @staticmethod
    def forward(ctx, t, mesh: Mesh):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        COUNTS["grad_all_reduce"] += 1
        return all_sum_(ctx.mesh, g.clone()), None


def _per_channel(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.view(1, -1, *([1] * (ndim - 2)))


def _accumulate(x: torch.Tensor) -> torch.dtype:
    """The dtype PyTorch's own BatchNorm sums x's statistics in: double on
    the CPU, fp32 (or x's wider dtype) on a card."""
    return torch.float64 if x.device.type == "cpu" else torch.promote_types(x.dtype,
                                                                            torch.float32)


class _BatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm of x (C at dim 1) with the statistics of the
    whole batch split over the ranks of `data` (None: this rank's alone),
    computed in fp32 or x's wider dtype and cast to x's dtype once, as a
    fused BatchNorm does, its sums taken as `_accumulate` says.  Each rank's
    per-channel count, mean and sum of
    squared deviations (two passes) are all-gathered and combined (Chan et
    al.'s pairwise update, in fp64): sums of x and x^2 would lose the
    variance of a channel whose mean is large against its spread.  The
    backward is SyncBatchNorm's: the per-channel sums of the gradient and of
    the gradient times the centred x all-reduced over `data`, so that x's
    gradient is the whole batch's; the affine's is this rank's share.  Only
    x is kept for it.  Returns y and the batch mean and biased variance
    (no gradient), for the running statistics."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float, data: Optional[Mesh]):
        nd, dims = x.dim(), [0] + list(range(2, x.dim()))
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        xa = x.to(_accumulate(x))
        mean = xa.mean(dims)
        m2 = (xa - _per_channel(mean, nd)).square().sum(dims)
        del xa
        c = mean.shape[0]
        rows = torch.cat([torch.full((1,), float(x.numel() // c), dtype=torch.float64,
                                     device=x.device), mean.double(), m2.double()])[None]
        if data is not None and data.size > 1:
            rows = gather(data, rows, 0)
            COUNTS["data_all_gather"] += 1
        ns, means, m2s = rows[:, :1], rows[:, 1:c + 1], rows[:, c + 1:]
        n = ns.sum()
        whole_mean = (ns * means).sum(0) / n
        var = ((m2s + ns * (means - whole_mean).square()).sum(0) / n).to(xf.dtype)
        mean = whole_mean.to(xf.dtype)
        invstd = torch.rsqrt(var + eps)
        y = (xf - _per_channel(mean, nd)) * _per_channel(invstd * weight.to(xf.dtype), nd)
        y = (y + _per_channel(bias.to(xf.dtype), nd)).to(x.dtype)
        ctx.save_for_backward(x, mean, invstd, weight)
        ctx.n, ctx.data = n.to(xf.dtype), data
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, g, _mean, _var):
        x, mean, invstd, weight = ctx.saved_tensors
        nd, dims = x.dim(), [0] + list(range(2, x.dim()))
        gf = g.to(mean.dtype)
        xc = x.to(mean.dtype) - _per_channel(mean, nd)
        acc = _accumulate(x)
        sums = torch.stack([gf.to(acc).sum(dims), (gf.to(acc) * xc.to(acc)).sum(dims)]).to(
            mean.dtype)
        dbias, dweight = sums[0].clone(), sums[1] * invstd
        if ctx.data is not None and ctx.data.size > 1:
            all_sum_(ctx.data, sums)
            COUNTS["data_all_reduce"] += 1
        dx = gf - _per_channel(sums[0] / ctx.n, nd) \
            - xc * _per_channel(invstd.square() * sums[1] / ctx.n, nd)
        dx = dx * _per_channel(invstd * weight.to(mean.dtype), nd)
        return (dx.to(x.dtype), dweight.to(weight.dtype), dbias.to(weight.dtype), None,
                None)


# ---- TensorParallelMode ------------------------------------------------------

# an activation's mark: (lo, hi, full), the channels [lo, hi) of `full` it
# holds along dim 1; the whole tensor gathered from it, with its version
_CHANNELS = "_tp_channels"
_GATHERED = "_tp_gathered"

# queries of a tensor's metadata
_META = frozenset("""
    __get__ __set__ dim size numel nelement element_size is_contiguous data_ptr stride
    storage_offset ndimension get_device is_floating_point is_complex __len__ __repr__
    __format__ __hash__ item tolist untyped_storage __bool__
""".split())
# casts and layouts of one tensor (also of a split weight)
_LAYOUT = frozenset("""
    to float double half bfloat16 type type_as contiguous clone detach cpu cuda
""".split())
# channel-local operations of one tensor
_UNARY = _LAYOUT | frozenset("""
    relu relu_ sigmoid silu gelu one_hot interpolate max_pool2d avg_pool2d
    adaptive_avg_pool2d
""".split())
# element-wise operations of several operands
_ELEMENTWISE = frozenset("""
    add add_ sub sub_ mul mul_ div div_ where copy_ __add__ __radd__ __iadd__ __sub__
    __rsub__ __isub__ __mul__ __rmul__ __imul__ __truediv__ __rtruediv__ __itruediv__
""".split())
# reductions along `dim`
_REDUCE = frozenset("sum mean amax amin argmax argmin max min".split())


def _slice(t) -> Optional[Tuple[int, int, int]]:
    return getattr(t, _CHANNELS, None) if isinstance(t, torch.Tensor) else None


def _mark(out, s):
    """`out` (a tensor with C at dim 1, or a tuple of them) marked as the
    channel slice `s`."""
    if isinstance(out, torch.Tensor):
        if out.dim() >= 2:
            setattr(out, _CHANNELS, s)
    elif isinstance(out, (tuple, list)):
        for t in out:
            _mark(t, s)
    return out


def _in_place(name: str) -> bool:
    return (name.endswith("_") and not name.startswith("_")) or name.startswith("__i") \
        or name == "__setitem__"


def _sizes(args, kwargs, key):
    """A shape given as one sequence or as several ints (`reshape`,
    `view`, `expand`, `permute`)."""
    if len(args) == 2 and isinstance(args[1], (tuple, list, torch.Size)):
        return list(args[1])
    return list(args[1:]) or list(kwargs.get(key, ()))


def _keeps_nc(index, ndim: int) -> bool:
    """Whether indexing a tensor of `ndim` dims with `index` keeps its dims
    0 and 1 whole and in place."""
    index = list(index) if isinstance(index, tuple) else [index]
    consuming = sum(1 for e in index if e is not None and e is not Ellipsis)
    dims = []
    for e in index:
        dims += [slice(None)] * (ndim - consuming) if e is Ellipsis else [e]
    dims += [slice(None)] * 2
    return all(isinstance(e, slice) and e == slice(None) for e in dims[:2])


class TensorParallelMode(TorchFunctionMode):
    """Run a model's forward with its weights split over the model axis
    `mesh` (the module docstring gives the rules); in train mode with the
    batch split over the data axis `data` (None: one rank).  While it is
    active, `ops.partition.active()` is this mode, for K2 and K1 and for
    train mode's BatchNorm and random draws."""

    def __init__(self, mesh: Mesh, data: Optional[Mesh] = None):
        super().__init__()
        self.mesh, self.data = mesh, data
        self._suspended = 0
        self._stale = {}              # BatchNorms whose running statistics hold a slice
        self._rules = {F.conv2d: self._conv2d, F.conv_transpose2d: self._conv_transpose2d,
                       F.batch_norm: self._batch_norm, torch.cat: self._cat}

    # -- entering and leaving, suspension -------------------------------------

    def __enter__(self):
        partition._ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        partition._ACTIVE.remove(self)
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def suspended(self):
        """Run code that sees a slice as an ordinary tensor."""
        self._suspended += 1
        try:
            yield
        finally:
            self._suspended -= 1

    # -- the collectives ---------------------------------------------------------

    def whole_tensor(self, t: torch.Tensor) -> torch.Tensor:
        """t whole: a slice all-gathered along C over the model axis (once
        per version of it), anything else itself."""
        s = _slice(t)
        if s is None:
            return t
        cached = getattr(t, _GATHERED, None)
        fresh = cached is None or cached[0] != t._version
        COUNTS["all_gather"] += fresh
        if self.mesh.size == 1:       # the slice is whole: a view, kept nowhere (kept on
            setattr(t, _GATHERED, (t._version, None))     # t, it would make a cycle)
            with self.suspended():
                return t.view_as(t)
        if not fresh:
            return cached[1]
        with self.suspended():
            y = _Gather.apply(t, self.mesh, 1)
            if t.dim() == 4 and not t.is_contiguous() and t.is_contiguous(
                    memory_format=torch.channels_last):
                y = y.contiguous(memory_format=torch.channels_last)
        setattr(t, _GATHERED, (t._version, y))
        return y

    def _cut(self, t: torch.Tensor, lo: int, hi: int, full: int) -> torch.Tensor:
        """Channels [lo, hi) of `full` of t: a slice of them as it is, a
        whole t cut, a slice of other channels gathered and cut."""
        if _slice(t) == (lo, hi, full):
            return t
        w = self.whole_tensor(t)
        if w.shape[1] != full:
            raise ValueError(f"tensor parallelism: a map of {w.shape[1]} channels meets a "
                             f"weight split from {full}")
        return self._cut_whole(w, 1, lo, hi)

    @staticmethod
    def _grad(t: Optional[torch.Tensor]) -> bool:
        return t is not None and t.requires_grad and torch.is_grad_enabled()

    def _cut_whole(self, t: Optional[torch.Tensor], dim: int, lo: int, hi: int):
        """[lo, hi) along `dim` of a whole tensor t (None stays None): its
        gradient comes back whole from every rank's slice."""
        if t is None:
            return None
        if self._grad(t) and self.mesh.size > 1:
            with self.suspended():
                return _Cut.apply(t, self.mesh, dim, lo, hi)
        return t.narrow(dim, lo, hi - lo)

    def _replicated(self, t: torch.Tensor) -> torch.Tensor:
        """A whole t that rank-specific work consumes: its gradient there is
        summed over the model axis."""
        if self._grad(t) and self.mesh.size > 1:
            with self.suspended():
                return _Replicated.apply(t, self.mesh)
        return t

    def _sum(self, part: torch.Tensor) -> torch.Tensor:
        """A row split's partial sums added over the model axis, in fp32 or
        part's wider dtype (in place where `part` is that and no gradient is
        taken)."""
        wide = part.to(torch.promote_types(part.dtype, torch.float32))
        with self.suspended():
            if self._grad(part):
                y = _Sum.apply(wide, self.mesh)
            else:
                y = all_sum_(self.mesh, wide)
        COUNTS["all_reduce"] += 1
        return y

    # -- the rules -----------------------------------------------------------------

    def _conv2d(self, func, args, kwargs):
        a = call_args(args, kwargs, ("input", "weight", "bias", "stride", "padding", "dilation",
                                 "groups"), (None, None, None, 1, 0, 1, 1))
        x, w, b, groups = a["input"], a["weight"], a["bias"], a["groups"]
        rest = (a["stride"], a["padding"], a["dilation"])
        split = split_of(w)
        if split is None:
            return func(self.whole_tensor(x), w, b, *rest, groups)
        _, _, lo, hi, full = split
        cut_b = self._cut_whole(b, 0, lo, hi)
        if split.kind == "column":
            if groups == 1:
                return _mark(func(self._replicated(self.whole_tensor(x)), w, cut_b, *rest, 1),
                             (lo, hi, full))
            if groups == full and w.shape[1] == 1:    # depthwise, on the same channels
                return _mark(func(self._cut(x, lo, hi, full), w, cut_b, *rest, hi - lo),
                             (lo, hi, full))
        elif groups == 1:
            part = func(self._cut(x, lo, hi, full), w, None, *rest, 1)
            y = self._sum(part)
            if b is not None:
                y.add_(b.to(y.dtype).view(1, -1, 1, 1))
            return y.to(part.dtype)
        raise NotImplementedError(f"tensor parallelism: conv2d with {groups} groups split "
                                  f"along its {split.kind}")

    def _conv_transpose2d(self, func, args, kwargs):
        a = call_args(args, kwargs, ("input", "weight", "bias", "stride", "padding",
                                 "output_padding", "groups", "dilation"),
                  (None, None, None, 1, 0, 0, 1, 1))
        x, w, b = a["input"], a["weight"], a["bias"]
        rest = (a["stride"], a["padding"], a["output_padding"], a["groups"], a["dilation"])
        split = split_of(w)
        if split is None:
            return func(self.whole_tensor(x), w, b, *rest)
        if split.kind != "column" or a["groups"] != 1:
            raise NotImplementedError("tensor parallelism: conv_transpose2d split along its "
                                      f"{split.kind} with {a['groups']} groups")
        _, _, lo, hi, full = split
        return _mark(func(self._replicated(self.whole_tensor(x)), w,
                          self._cut_whole(b, 0, lo, hi), *rest), (lo, hi, full))

    def _batch_norm(self, func, args, kwargs):
        a = call_args(args, kwargs, ("input", "running_mean", "running_var", "weight", "bias",
                                 "training", "momentum", "eps"),
                  (None, None, None, None, None, False, 0.1, 1e-5))
        if a["training"]:
            raise NotImplementedError("tensor parallelism: BatchNorm in train mode runs through "
                                      "models.blocks.batch_norm (the whole batch's statistics)")
        s = _slice(a["input"])
        if s is None:
            return func(*args, **kwargs)
        lo, hi, _ = s

        def cut(t):
            return None if t is None else t[lo:hi]

        return _mark(func(a["input"], cut(a["running_mean"]), cut(a["running_var"]),
                          cut(a["weight"]), cut(a["bias"]), a["training"], a["momentum"],
                          a["eps"]), s)

    def _cat(self, func, args, kwargs):
        a = call_args(args, kwargs, ("tensors", "dim"), (None, 0))
        ts = list(a["tensors"])
        slices = {_slice(t) for t in ts}
        if len(slices) == 1 and None not in slices and a["dim"] % ts[0].dim() != 1:
            return _mark(func(ts, a["dim"]), slices.pop())
        return func([self.whole_tensor(t) for t in ts], a["dim"])

    def _elementwise(self, func, name, args, kwargs, s):
        """An element-wise operation whose sliced operands carry the slice
        `s`: whole operands are cut to it (those broadcast along C kept);
        the result is the slice.  None where it is not local (an in-place
        write into a whole tensor)."""
        lo, hi, full = s
        first = args[0] if args else None
        if _in_place(name) and _slice(first) is None:
            return None
        ndim = max(t.dim() for t in tensors_of((args, kwargs)) if _slice(t) is not None)

        def cut(t):
            if _slice(t) is not None:
                return t
            c = 1 - (ndim - t.dim())                  # C's dim in t, right-aligned
            if c >= 0 and t.shape[c] == full and full != hi - lo:
                return self._cut_whole(t, c, lo, hi)
            if c < 0 or t.shape[c] == 1:              # broadcast along C
                return self._replicated(t)
            return t

        return _mark(func(*replace_tensors(args, cut), **replace_tensors(kwargs, cut)), s)

    def _local(self, func, name, args, kwargs, x, s):
        """The channel-local operations of one sliced tensor x that keep N
        and C in place: their result is the slice, else None."""
        if name in _UNARY:
            if name == "type_as" or len(tensors_of((args, kwargs))) == 1:
                return _mark(func(*args, **kwargs), s)
            return None
        nd = x.dim()
        if name == "pad":
            pad = call_args(args[1:], kwargs, ("pad",), ((),))["pad"]
            keep = len(pad) <= 2 * (nd - 2)
        elif name in _REDUCE:
            dims = call_args(args[1:], {k: v for k, v in kwargs.items() if k != "input"},
                         ("dim",), (None,))["dim"]
            if isinstance(dims, torch.Tensor):             # torch.max(a, b)
                return None
            dims = range(nd) if dims is None else [dims] if isinstance(dims, int) else dims
            keep = not {d % nd for d in dims} & {0, 1}
        elif name in ("reshape", "view"):
            shape = _sizes(args, kwargs, "shape")
            keep = len(shape) >= 2 and list(shape[:2]) == list(x.shape[:2])
        elif name == "permute":
            dims = _sizes(args, kwargs, "dims")
            keep = [d % nd for d in dims[:2]] == [0, 1]
        elif name == "expand":
            sizes = _sizes(args, kwargs, "size")
            keep = len(sizes) == nd and all(v in (-1, x.shape[i]) for i, v in
                                            enumerate(sizes[:2]))
        elif name == "unsqueeze":
            d = call_args(args[1:], kwargs, ("dim",), (0,))["dim"]
            keep = d % (nd + 1) >= 2
        elif name == "__getitem__":
            keep = _keeps_nc(args[1], nd)
        else:
            keep = False
        return _mark(func(*args, **kwargs), s) if keep else None

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._suspended:
            return func(*args, **kwargs)
        rule = self._rules.get(func)
        if rule is not None:
            return rule(func, args, kwargs)
        name = func_name(func)
        if name in _META:
            return func(*args, **kwargs)
        tensors = tensors_of((args, kwargs))
        weights = [t for t in tensors if split_of(t) is not None]
        if weights:                   # a split weight may only be cast
            if name in _LAYOUT and len(tensors) == 1:
                out = func(*args, **kwargs)
                setattr(out, partition.SPLIT, split_of(weights[0]))
                return out
            raise NotImplementedError(f"tensor parallelism has no rule for {name or func!r} "
                                      "on a split weight")
        slices = {_slice(t) for t in tensors} - {None}
        if not slices:
            return func(*args, **kwargs)
        if len(slices) == 1:
            s = next(iter(slices))
            out = None
            if name in _ELEMENTWISE:
                out = self._elementwise(func, name, args, kwargs, s)
            elif args and _slice(args[0]) == s:
                out = self._local(func, name, args, kwargs, args[0], s)
            if out is not None:
                return out
        if args and _slice(args[0]) is not None and _in_place(name):
            raise NotImplementedError(f"tensor parallelism: {name} writes into a channel slice")
        def whole(t):
            return self.whole_tensor(t) if _slice(t) is not None else t

        return func(*replace_tensors(args, whole), **replace_tensors(kwargs, whole))

    # -- the fused kernels' hook (ops.partition) -----------------------------------

    def conv3x3(self, x: torch.Tensor, layer: nn.Conv2d, bn: Optional[nn.BatchNorm2d],
                relu: bool, dtype: torch.dtype, run) -> torch.Tensor:
        """K2 for `layer` + `bn` (+ ReLU) on x, by the split of its weight:
        `run(x, packed=..., relu=...)` launches it on an NCHW input (its own
        pack where `packed` is None).  Whole: on x whole.  Column: on x
        whole with the BN folded on the weight's channels; the result is
        their slice.  Row: on x's slice of the weight's input channels with
        scale 1, shift 0 and no ReLU, the partial sums added over the model
        axis in fp32, then the bias and BN, then the ReLU, cast to `dtype`
        once."""
        split = split_of(layer.weight)
        with self.suspended():
            if split is None:
                COUNTS["k2_whole"] += 1
                return run(self.whole_tensor(x), relu=relu)
            _, _, lo, hi, full = split
            if split.kind == "column":
                COUNTS["k2_column"] += 1
                y = run(self.whole_tensor(x),
                        packed=packed_conv3x3(layer, bn, dtype, x.device, (lo, hi)), relu=relu)
                return _mark(y, (lo, hi, full))
            COUNTS["k2_row"] += 1
            part = run(self._cut(x, lo, hi, full),
                       packed=packed_conv3x3(layer, bn, dtype, x.device, epilogue=False),
                       relu=False)
            y = self._sum(part)
            bias = layer.bias
            if bn is not None:
                scale, shift = fold_bn_params(bn.weight, bn.bias, bn.running_mean,
                                              bn.running_var, bn.eps, bias)
            else:
                scale = torch.ones_like(y[0, :, 0, 0])
                shift = torch.zeros_like(scale) if bias is None else bias
            y.mul_(scale.float().view(1, -1, 1, 1)).add_(shift.float().view(1, -1, 1, 1))
            return (y.relu_() if relu else y).to(dtype)

    def mbconv(self, x: torch.Tensor, block: nn.Module, run) -> torch.Tensor:
        """K1 (`run(x, weights)`) on x whole, the `MBConvBlock` `block`
        folded from its weights whole: a split weight all-gathered over the
        model axis for the call, its storage left sharded.  The result is
        whole."""
        gathered = []

        def whole_weight(t):
            split = split_of(t)
            if split is None:
                return t
            gathered.append(t)
            COUNTS["all_gather"] += 1
            return gather(self.mesh, t.detach(), split.dim)

        with self.suspended():
            y = run(self.whole_tensor(x), block.fold(whole_weight))
        COUNTS["k1_gathered"] += bool(gathered)
        return y

    # -- train mode's hooks (ops.partition) ------------------------------------------

    def batch_norm(self, x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
        """`models.blocks.batch_norm` in train mode with the whole batch's
        statistics over the data axis (`_BatchNorm`), normalised with the
        biased variance; on a slice, its channels of the affine and of the
        running statistics, which `sync_running_stats` makes whole
        afterwards."""
        s = _slice(x)
        lo, hi = (s[0], s[1]) if s is not None else (0, x.shape[1])
        with self.suspended():
            weight = bn.weight if s is None else self._cut_whole(bn.weight, 0, lo, hi)
            bias = bn.bias if s is None else self._cut_whole(bn.bias, 0, lo, hi)
            y, mean, var = _BatchNorm.apply(x, weight, bias, bn.eps, self.data)
            m = 1.0 - bn.momentum
            with torch.no_grad():
                bn.running_mean[lo:hi].mul_(m).add_(mean, alpha=1.0 - m)
                bn.running_var[lo:hi].mul_(m).add_(var, alpha=1.0 - m)
        if s is None:
            return y
        self._stale[id(bn)] = (bn, lo, hi)
        return _mark(y, s)

    def sync_running_stats(self) -> None:
        """The running statistics of every BatchNorm that ran on a slice,
        all-gathered whole over the model axis (one collective): afterwards
        every rank holds them whole and equal."""
        stale, self._stale = list(self._stale.values()), {}
        if not stale or self.mesh.size == 1:
            return
        with torch.no_grad():
            flat = torch.cat([t[lo:hi] for bn, lo, hi in stale
                              for t in (bn.running_mean, bn.running_var)])
            parts = gather(self.mesh, flat, 0).view(self.mesh.size, -1)
            COUNTS["all_gather"] += 1
            at = 0
            for bn, lo, hi in stale:
                for t in (bn.running_mean, bn.running_var):
                    t.copy_(parts[:, at:at + hi - lo].reshape(-1))
                    at += hi - lo

    def uniform(self, x: torch.Tensor, generator: torch.Generator,
                per_sample: bool = False) -> torch.Tensor:
        """fp32 uniforms in [0, 1) for x: this rank's part of the draws over
        the whole batch from `generator` (seeded alike on every rank), so
        that they are the one process's draws on the whole batch at this
        rank's rows and, for a slice, channels.  Each element of x whole
        (in x's memory layout, as `torch.empty_like` draws), or one a
        sample, `[N, 1, 1, 1]`, with `per_sample`."""
        n = x.shape[0]
        n_data, d = (1, 0) if self.data is None else (self.data.size, self.data.rank)
        s = _slice(x)
        with self.suspended():
            if per_sample:
                u = torch.rand((n * n_data, 1, 1, 1), device=x.device, generator=generator)
            else:
                layout = (torch.channels_last if x.dim() == 4 and not x.is_contiguous()
                          and x.is_contiguous(memory_format=torch.channels_last)
                          else torch.contiguous_format)
                shape = (n * n_data, x.shape[1] if s is None else s[2], *x.shape[2:])
                u = torch.empty(shape, dtype=torch.float32, device=x.device,
                                memory_format=layout).uniform_(generator=generator)
                if s is not None:
                    u = u[:, s[0]:s[1]]
            return u[d * n:(d + 1) * n]
