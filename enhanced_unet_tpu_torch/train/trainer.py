"""Training engine of the flagship, ported from
`enhanced_unet_tpu/train/trainer.py`.

One `train_step` per batch: the train-mode forward (batch-statistics
BatchNorm with flax's running-stat update, dropout and stochastic depth from
an explicit `torch.Generator`), `combined_loss_with_aux`, the backward, and
clip-by-global-norm + AdamW with the reference's epoch-granular LR table.
Training runs the stock PyTorch path of every block, as the JAX package's
does: the fused kernels serve eval-mode forwards only (`make_eval_step`).

`AdamW` is the port's own, on `torch._foreach_*` ops (a few launches per
step over the whole parameter list), with optax's semantics for
`optax.chain(optax.clip_by_global_norm(max_norm), optax.adamw(...))`:

- clip: g / norm * max_norm when norm >= max_norm (no epsilon in the norm);
- mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu, each product with a
  stored moment taken in that moment's dtype (with a bf16 mu, b1 itself is
  rounded to bf16); this step's direction uses mu before it is rounded to
  `mu_dtype` for storage (nu stays fp32);
- bias correction at count + 1, eps = 1e-8 outside the square root, no
  eps_root;
- decoupled weight decay on every parameter: p -= lr (m_hat / (sqrt(v_hat)
  + eps) + wd p), lr from the table at the count of earlier updates.

Parameters without a gradient (the UNet++ head block's never-called
`attention1`) are left out of the norm and the update, as the JAX parameter
tree has no such leaves.

With a mesh (`parallel.make_mesh`), the step is one data-parallel replica's,
the JAX step with `axis_name`: between the backward and the update, one
all-reduce takes the mean over the ranks of the gradients (before the clip,
as `pmean` precedes `tx.update`), the loss and the BatchNorm running
statistics that this rank's forward has just updated.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch
import torch.nn as nn

from enhanced_unet_tpu_torch.config import TrainConfig
from enhanced_unet_tpu_torch.device import resolve_device
from enhanced_unet_tpu_torch.metrics.semantic import batched_confusion_matrix
from enhanced_unet_tpu_torch.ops.losses import combined_loss_with_aux
from enhanced_unet_tpu_torch.train.schedule import make_lr_fn, reference_lr_schedule

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass
class AdamWState:
    """`count` updates made; first and second moments by parameter name."""

    count: int
    mu: Tensors
    nu: Tensors


class AdamW:
    """Clip by global norm, then AdamW (optax's semantics, see the module
    docstring).  `update` changes the parameters and the gradients in
    place and returns the new state."""

    def __init__(self, lr_fn: Callable[[int], float], b1: float, b2: float,
                 weight_decay: float, max_norm: float,
                 mu_dtype: torch.dtype = torch.float32, eps: float = 1e-8):
        self.lr_fn, self.b1, self.b2 = lr_fn, b1, b2
        self.weight_decay, self.max_norm = weight_decay, max_norm
        self.mu_dtype, self.eps = mu_dtype, eps

    def init(self, params: Tensors) -> AdamWState:
        return AdamWState(
            count=0,
            mu={n: torch.zeros_like(p, dtype=self.mu_dtype) for n, p in params.items()},
            nu={n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()})

    @torch.no_grad()
    def update(self, params: Tensors, grads: Dict[str, Optional[torch.Tensor]],
               state: AdamWState, norm: Optional[torch.Tensor] = None) -> AdamWState:
        """`norm`, when given, is the gradients' global norm to clip by (a
        sharded model's, taken over the ranks), else their own."""
        names = [n for n in params if grads.get(n) is not None]
        p = [params[n] for n in names]
        g = [grads[n] for n in names]
        if norm is None:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
        clip = norm >= self.max_norm
        torch._foreach_div_(g, torch.where(clip, norm, 1.0))
        torch._foreach_mul_(g, torch.where(clip, self.max_norm, 1.0))

        b1, b2, count = self.b1, self.b2, state.count + 1
        mu = torch._foreach_mul(g, 1.0 - b1)
        # b1 in mu's dtype, as optax's weakly typed constant meets a bf16 mu
        b1_mu = torch.tensor(b1, dtype=self.mu_dtype).item()
        torch._foreach_add_(mu, torch._foreach_mul([state.mu[n] for n in names], b1_mu))
        nu = torch._foreach_mul(g, g)
        torch._foreach_mul_(nu, 1.0 - b2)
        torch._foreach_add_(nu, torch._foreach_mul([state.nu[n] for n in names], b2))

        one = np.float32(1.0)
        step = torch._foreach_div(mu, float(one - np.float32(b1) ** np.float32(count)))
        den = torch._foreach_div(nu, float(one - np.float32(b2) ** np.float32(count)))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(step, den)
        torch._foreach_add_(step, torch._foreach_mul(p, self.weight_decay))
        torch._foreach_mul_(step, -self.lr_fn(state.count))
        torch._foreach_add_(p, step)

        if self.mu_dtype != torch.float32:
            mu = [m.to(self.mu_dtype) for m in mu]
        return AdamWState(count=count, mu={**state.mu, **dict(zip(names, mu))},
                          nu={**state.nu, **dict(zip(names, nu))})


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BatchNorm running statistics), the
    optimizer's state and the number of steps taken."""

    step: int
    model: nn.Module
    opt_state: AdamWState
    tx: AdamW


def make_optimizer(cfg: TrainConfig, steps_per_epoch: int) -> AdamW:
    """clip-by-global-norm -> AdamW with the reference's warmup +
    cosine-restarts LR table, one LR per epoch."""
    o = cfg.optimizer
    table = reference_lr_schedule(
        base_lr=o.base_lr, total_epochs=cfg.num_epochs,
        warmup_epochs=cfg.warmup_epochs, t0=cfg.cosine_t0, t_mult=o.t_mult,
        eta_min=o.eta_min, start_factor=o.warmup_start_factor)
    return AdamW(make_lr_fn(table, steps_per_epoch), b1=o.betas[0], b2=o.betas[1],
                 weight_decay=o.weight_decay, max_norm=o.grad_clip_norm,
                 mu_dtype=getattr(torch, o.mu_dtype))


def create_train_state(model: nn.Module, cfg: TrainConfig, steps_per_epoch: int,
                       device: Optional[Union[str, torch.device]] = None) -> TrainState:
    """`model` (weights as they are) on `device` (None: the CUDA card, raising
    without one), with a fresh optimizer state."""
    model = model.to(resolve_device(device))
    tx = make_optimizer(cfg, steps_per_epoch)
    return TrainState(step=0, model=model,
                      opt_state=tx.init(dict(model.named_parameters())), tx=tx)


def make_train_step(cfg: TrainConfig, mesh=None):
    """`train_step(state, images, masks, valid, generator) -> (state,
    {"loss": ...})`: images [B,H,W,3] fp32 in [0, 1], masks [B,H,W] int,
    valid [B,H,W] bool, all on the model's device; `generator` (on that
    device) draws the dropout and stochastic-depth masks.  The model's
    parameters and running statistics change in place; each parameter's
    `.grad` holds its clipped gradient afterwards.  With `mesh` (a
    `parallel.Mesh`), gradients, loss and running statistics are the means
    over its ranks (the module docstring)."""
    loss_cfg = cfg.loss

    def train_step(state: TrainState, images: torch.Tensor, masks: torch.Tensor,
                   valid: torch.Tensor, generator: Optional[torch.Generator]):
        model = state.model.train()
        model.zero_grad(set_to_none=True)
        logits, aux = model(images, generator=generator)
        loss = combined_loss_with_aux(logits, aux, masks, loss_cfg, valid)
        loss.backward()
        loss = loss.detach()
        params = dict(model.named_parameters())
        if mesh is not None:
            mesh.all_mean_([p.grad for p in params.values() if p.grad is not None]
                           + [loss]
                           + [b for n, b in model.named_buffers()
                              if n.endswith(("running_mean", "running_var"))])
        opt_state = state.tx.update(params, {n: p.grad for n, p in params.items()},
                                    state.opt_state)
        return (dataclasses.replace(state, step=state.step + 1, opt_state=opt_state),
                {"loss": loss})

    return train_step


def param_grad_norms(grads: Dict[str, Optional[torch.Tensor]]) -> Dict[str, float]:
    """{parameter name: mean |grad|}, for the gradient-flow plot; names
    without a gradient are left out."""
    named = [(n, g) for n, g in grads.items() if g is not None]
    means = torch.stack([g.abs().mean() for _, g in named]).tolist()
    return {n: m for (n, _), m in zip(named, means)}


def compute_grad_norms(state: TrainState, images: torch.Tensor, masks: torch.Tensor,
                       valid: torch.Tensor, cfg: TrainConfig) -> Dict[str, float]:
    """One-off gradient magnitudes of the training loss on a batch
    (diagnostics): a train-mode forward with dropout drawn from seed 0,
    leaving the parameters, their `.grad` and the running statistics as
    they were."""
    model = state.model
    was_training = model.training
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    model.train()
    try:
        gen = torch.Generator(device=images.device).manual_seed(0)
        logits, aux = model(images, generator=gen)
        loss = combined_loss_with_aux(logits, aux, masks, cfg.loss, valid)
        named = list(model.named_parameters())
        grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    finally:
        model.load_state_dict(buffers, strict=False)
        model.train(was_training)
    return param_grad_norms({n: g for (n, _), g in zip(named, grads)})


def make_eval_step(cfg: TrainConfig):
    """`eval_step(state, images, masks, valid) -> (logits, cms)`: an
    eval-mode forward under `no_grad` (the fused kernels' path on the
    card), argmax, pixels outside `valid` forced to class 0 in both the
    prediction and the mask, and [B, 3, 3] int64 confusion matrices
    (`cm[gt, pred]`) on the device."""
    del cfg  # the eval step has no settings; kept for the JAX signature

    def eval_step(state: TrainState, images: torch.Tensor, masks: torch.Tensor,
                  valid: torch.Tensor):
        model = state.model.eval()
        with torch.no_grad():
            logits, _ = model(images)
        zero = torch.zeros((), dtype=torch.long, device=logits.device)
        pred = torch.where(valid, logits.argmax(-1), zero)
        gt = torch.where(valid, masks.long(), zero)
        return logits, batched_confusion_matrix(pred, gt)

    return eval_step
