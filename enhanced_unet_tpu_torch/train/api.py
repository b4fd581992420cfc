"""Training entry point, ported from `enhanced_unet_tpu/train/api.py`
(`train_model` and what it needs): the reference's protocol from a folder
of labelme-annotated micrographs to a best-mIoU checkpoint.  Per-model
epochs, batch and patience come from the preset; every
`eval_every_epochs` epochs a validation gate (the full `Evaluator` by
default) decides whether the state is the best so far; early stopping
after `early_stop_min_epoch`; `last_model` always written, for `resume`.

Not served yet (each raises `NotImplementedError`): training over more
than one device, and ImageNet-pretrained encoder weights.  The other entry
points of the JAX module (`evaluate_model`, `train_and_evaluate`,
`visualize_model`) wait for the reports' port.
"""

from __future__ import annotations

import copy
import os
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from enhanced_unet_tpu_torch.config import SERVING_OPTIMIZED_KWARGS, TrainConfig, get_preset
from enhanced_unet_tpu_torch.data.dataset import CellDataset
from enhanced_unet_tpu_torch.data.loader import BatchLoader
from enhanced_unet_tpu_torch.device import resolve_device
from enhanced_unet_tpu_torch.metrics.semantic import metrics_from_confusion
from enhanced_unet_tpu_torch.models import get_model
from enhanced_unet_tpu_torch.train.checkpoint import (
    checkpoint_exists,
    load_checkpoint,
    save_checkpoint,
)
from enhanced_unet_tpu_torch.train.evaluator import Evaluator
from enhanced_unet_tpu_torch.train.schedule import reference_lr_schedule
from enhanced_unet_tpu_torch.train.trainer import (
    TrainState,
    compute_grad_norms,
    create_train_state,
    make_eval_step,
    make_train_step,
)


def _pad_shape(max_size: int) -> tuple:
    s = (max_size // 32) * 32
    return (s, s)


def _build_state(model_name: str, cfg: TrainConfig, steps_per_epoch: int,
                 dtype: torch.dtype = torch.bfloat16,
                 device: Optional[Union[str, torch.device]] = None) -> TrainState:
    """`model_name` with weights seeded from `cfg.seed`, and a fresh
    optimizer state, on `device`."""
    kwargs = {}
    if model_name == "enhanced_unet":
        kwargs["packed_decoder"] = cfg.model.packed_decoder
        if cfg.model.serving_preset == "optimized":
            kwargs.update(SERVING_OPTIMIZED_KWARGS["enhanced_unet"])
    model = get_model(model_name, dtype=dtype, device=device, seed=cfg.seed, **kwargs)
    return create_train_state(model, cfg, steps_per_epoch=max(steps_per_epoch, 1),
                              device=device)


def quick_val_miou(state: TrainState, cfg: TrainConfig, loader,
                   eval_step=None) -> Dict[str, float]:
    """Argmax mIoU of `state` over the loader's batches, from confusion
    matrices summed on the host: the cheap alternative to the full
    `Evaluator` gate."""
    if eval_step is None:
        eval_step = make_eval_step(cfg)
    cms = []
    for batch in loader:
        _, cm = eval_step(state, batch["images"], batch["semantic_masks"],
                          batch["valid_mask"])
        cms.append(cm[: batch["n_real"]].cpu().numpy())
    if not cms:
        return {"sem_mean_iou": 0.0}
    return metrics_from_confusion(np.concatenate(cms).sum(axis=0))


def train_model(model_name: str, data_dir: str = "data", num_epochs: int = 50,
                skip_training: bool = False, resume: bool = False,
                checkpoint_dir: str = "checkpoints", max_size: int = 640,
                cfg: Optional[TrainConfig] = None, use_full_evaluator_gate: bool = True,
                dtype: torch.dtype = torch.bfloat16, num_devices: Optional[int] = None,
                pretrained_dir: Optional[str] = None, log=print,
                device: Optional[Union[str, torch.device]] = None) -> str:
    """Train one model with the reference's protocol on `device` (None: the
    CUDA card, raising without one); returns the best checkpoint's path.

    `resume=True` continues from `last_model` (else `best_model`): epoch,
    step, weights, optimizer state, history and the best-mIoU gate.
    `skip_training=True` returns an existing `best_model` untouched.  The
    gate is the full `Evaluator` (native-size enhance, TTA for
    enhanced_unet, the threshold cascade, instances) unless
    `use_full_evaluator_gate=False`, which takes the argmax mIoU of
    `quick_val_miou`."""
    cfg = cfg or get_preset(model_name, num_epochs=num_epochs, data_dir=data_dir)
    n_dev = int(num_devices if num_devices is not None else cfg.num_devices)
    if n_dev > 1:
        raise NotImplementedError(
            f"num_devices={n_dev}: multi-device training is not ported yet "
            "(ROADMAP.md, Queue 1 item 5)")
    if pretrained_dir:
        raise NotImplementedError(
            "pretrained_dir: pretrained encoder weights are not ported yet "
            "(ROADMAP.md, Queue 1 item 2, convert/pretrained.py)")
    device = resolve_device(device)
    ckpt_path = os.path.join(checkpoint_dir, model_name, "best_model")
    last_path = os.path.join(checkpoint_dir, model_name, "last_model")
    os.makedirs(os.path.dirname(ckpt_path), exist_ok=True)

    if skip_training and checkpoint_exists(ckpt_path):
        log(f"Found trained checkpoint: {ckpt_path}; skipping training")
        return ckpt_path

    pad_shape = _pad_shape(max_size)
    train_loader = BatchLoader(CellDataset(data_dir, split="train", max_size=max_size),
                               cfg.batch_size, pad_shape, train=True, seed=cfg.seed,
                               device=device)
    # the full Evaluator enhances each image itself at native size, so its
    # loader skips the device preprocess
    val_loader = BatchLoader(CellDataset(data_dir, split="val", max_size=max_size),
                             cfg.batch_size, pad_shape, train=False,
                             preprocess=not use_full_evaluator_gate, device=device)

    state = _build_state(model_name, cfg, len(train_loader), dtype, device)
    train_step = make_train_step(cfg)
    eval_step = None if use_full_evaluator_gate else make_eval_step(cfg)
    generator = torch.Generator(device=device).manual_seed(cfg.seed + 1)

    history = {
        "train_loss": [], "val_loss": [], "val_miou": [],
        "val_live_iou": [], "val_dead_iou": [], "val_dice": [],
        "learning_rate": [], "epoch_axis": [], "epoch_time_sec": [],
        "images_per_sec": [],
    }
    lr_table = reference_lr_schedule(
        cfg.optimizer.base_lr, cfg.num_epochs, cfg.warmup_epochs, cfg.cosine_t0,
        cfg.optimizer.t_mult, cfg.optimizer.eta_min, cfg.optimizer.warmup_start_factor)

    best_miou, best_loss = 0.0, float("inf")
    patience_counter = 0
    start_epoch = 0
    if resume:
        resume_from = (last_path if checkpoint_exists(last_path)
                       else ckpt_path if checkpoint_exists(ckpt_path) else None)
        if resume_from:
            state, meta = load_checkpoint(resume_from, state)
            start_epoch = int(meta.get("epoch", 0))
            best_miou = float(meta.get("best_miou", 0.0))
            best_loss = float(meta.get("best_loss", float("inf")))
            saved_history = meta.get("history", {})
            for k in history:
                if k in saved_history:
                    history[k] = list(saved_history[k])
            log(f"Resuming from {resume_from} at epoch {start_epoch} "
                f"(best mIoU {best_miou:.4f})")

    gate_evaluator = None  # one Evaluator, on its own copy of the model

    epoch = start_epoch - 1  # stays if the budget is already spent
    for epoch in range(start_epoch, cfg.num_epochs):
        t0 = time.perf_counter()
        # the loss adds up on the device: one host sync per epoch
        epoch_loss, n_batches = torch.zeros((), device=device), 0
        last_batch = None
        for batch in train_loader:
            state, m = train_step(state, batch["images"], batch["semantic_masks"],
                                  batch["valid_mask"], generator)
            epoch_loss = epoch_loss + m["loss"]
            n_batches += 1
            last_batch = batch
        loss = float(epoch_loss) / max(n_batches, 1)
        dt = time.perf_counter() - t0
        history["train_loss"].append(loss)
        history["learning_rate"].append(float(lr_table[epoch]))
        history["epoch_time_sec"].append(dt)
        history["images_per_sec"].append(n_batches * cfg.batch_size / dt if dt > 0 else 0.0)
        log(f"Epoch {epoch + 1}/{cfg.num_epochs} loss={loss:.4f} "
            f"lr={lr_table[epoch]:.6f} ({dt:.1f}s)")

        if (epoch + 1) % cfg.eval_every_epochs == 0:
            if use_full_evaluator_gate:
                if gate_evaluator is None:
                    gate_evaluator = Evaluator(copy.deepcopy(state.model), model_name,
                                               enable_tta=cfg.enable_tta, verbose=False,
                                               device=device)
                gate_evaluator.update_state(state)
                val = gate_evaluator.evaluate(val_loader)
            else:
                val = quick_val_miou(state, cfg, val_loader, eval_step)

            # gradient magnitudes on the last train batch (the gradient-flow plot)
            if last_batch is not None:
                history["grad_norms"] = compute_grad_norms(
                    state, last_batch["images"], last_batch["semantic_masks"],
                    last_batch["valid_mask"], cfg)
            val_iou = val.get("sem_mean_iou", 0.0)
            history["val_miou"].append(val_iou)
            history["val_live_iou"].append(val.get("sem_live_iou", 0.0))
            history["val_dead_iou"].append(val.get("sem_dead_iou", 0.0))
            history["val_dice"].append([val.get("sem_live_dice", 0.0),
                                        val.get("sem_dead_dice", 0.0)])
            history["val_loss"].append(loss)
            history["epoch_axis"].append(epoch + 1)
            log(f"  val mIoU={val_iou:.4f} live={val.get('sem_live_iou', 0):.4f} "
                f"dead={val.get('sem_dead_iou', 0):.4f}")

            if val_iou > best_miou:
                best_miou, best_loss = val_iou, loss
                patience_counter = 0
                save_checkpoint(ckpt_path, state, epoch + 1, best_miou, best_loss, history)
                log(f"  saved best (mIoU {best_miou:.4f})")
            else:
                patience_counter += 1

        if patience_counter >= cfg.patience and epoch > cfg.early_stop_min_epoch:
            log(f"Early stopping at epoch {epoch + 1}")
            break

    # the final state always, for resume; best_model keeps the gate's choice
    final_epoch = min(epoch + 1, cfg.num_epochs) if cfg.num_epochs else 0
    save_checkpoint(last_path, state, final_epoch, best_miou, best_loss, history)
    if not checkpoint_exists(ckpt_path):
        # never validated above 0.0: the final state stands as the best
        save_checkpoint(ckpt_path, state, final_epoch, best_miou, best_loss, history)
    return ckpt_path
