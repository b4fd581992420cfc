"""Entry points, ported from `enhanced_unet_tpu/train/api.py`: the
reference's protocol from a folder of labelme-annotated micrographs to a
best-mIoU checkpoint (`train_model`), its evaluation into
`results/<model>/<model>_results.json` and the figure suite
(`evaluate_model`), the figures alone (`visualize_model`), label-free
prediction over a folder of images (`predict_model`) and both steps in one
call (`train_and_evaluate`).

Per-model epochs, batch and patience come from the preset; every
`eval_every_epochs` epochs a validation gate (the full `Evaluator` by
default) decides whether the state is the best so far; early stopping
after `early_stop_min_epoch`; `last_model` always written, for `resume`.
Every entry point runs on `device` (None: the CUDA card, raising without
one).  `train_model(num_devices=N)` trains data-parallel, one process per
device (`parallel/`): it starts N workers itself, or, inside a process
group that is already initialised (`torchrun`), runs as its rank.
"""

from __future__ import annotations

import copy
import csv
import json
import os
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from enhanced_unet_tpu_torch.config import SERVING_OPTIMIZED_KWARGS, TrainConfig, get_preset
from enhanced_unet_tpu_torch.convert.pretrained import initialize_pretrained, required_weights
from enhanced_unet_tpu_torch.convert.torch_import import load_torch_checkpoint
from enhanced_unet_tpu_torch.data.dataset import (
    CellDataset,
    _read_rgb,
    _resize_image,
    snap_to_multiple,
)
from enhanced_unet_tpu_torch.data.loader import BatchLoader
from enhanced_unet_tpu_torch.device import resolve_device
from enhanced_unet_tpu_torch.metrics.semantic import metrics_from_confusion
from enhanced_unet_tpu_torch.models import get_model
from enhanced_unet_tpu_torch.parallel import (
    make_mesh,
    replica_seed,
    replicate_state,
    spawn,
)
from enhanced_unet_tpu_torch.postprocess.instances import semantic_to_instances
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
from enhanced_unet_tpu_torch.viz.visualizer import CLASS_COLORS, Visualizer


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


def _train_rank(mesh, model_name: str, kwargs: Dict) -> None:
    """One spawned rank of `train_model(num_devices=N)`."""
    train_model(model_name, device=mesh.device, **kwargs)


def _from_rank0(mesh, values):
    """Rank 0's `values` (floats) on every rank of `mesh` (None: as they
    are), so that every rank takes rank 0's branch."""
    if mesh is None:
        return values
    t = torch.tensor(values, dtype=torch.float64, device=mesh.device)
    mesh.broadcast_([t])
    return t.tolist()


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
    `quick_val_miou`.  `pretrained_dir` (not on resume) holds the
    ImageNet encoder files of `convert.pretrained.WEIGHT_MANIFEST`, loaded
    before the first step; a model without pretrained encoders ignores
    it.

    `num_devices` (or `cfg.num_devices`) N > 1 trains data-parallel, one
    process per device, each with its own `cfg.batch_size` rows (the global
    batch is N times that): with no process group initialised, N new
    workers (`parallel.spawn`: the cards `cuda:0..N-1`, or N CPU processes
    for `device="cpu"`; the arguments are pickled, `log` included), else
    this process as its rank of the group, whose size must be N.  Rank 0
    alone runs the gate, logs and writes the checkpoints; the other ranks
    wait for it in `Mesh.barrier` and take its decisions."""
    cfg = cfg or get_preset(model_name, num_epochs=num_epochs, data_dir=data_dir)
    n_dev = int(num_devices if num_devices is not None else cfg.num_devices)
    device = resolve_device(device)
    ckpt_path = os.path.join(checkpoint_dir, model_name, "best_model")
    last_path = os.path.join(checkpoint_dir, model_name, "last_model")
    group = torch.distributed.is_available() and torch.distributed.is_initialized()
    if n_dev > 1 and not group:
        spawn(_train_rank, n_dev, (model_name, dict(
            data_dir=data_dir, num_epochs=num_epochs, skip_training=skip_training,
            resume=resume, checkpoint_dir=checkpoint_dir, max_size=max_size, cfg=cfg,
            use_full_evaluator_gate=use_full_evaluator_gate, dtype=dtype,
            num_devices=n_dev, pretrained_dir=pretrained_dir, log=log)), device=device)
        return ckpt_path
    mesh = make_mesh(n_dev, device=device) if group else None
    if mesh is not None:
        device = mesh.device
        if mesh.size == 1:
            mesh = None
    lead = mesh is None or mesh.rank == 0
    if not lead:
        log = lambda *args: None  # noqa: E731
    os.makedirs(os.path.dirname(ckpt_path), exist_ok=True)

    if skip_training and checkpoint_exists(ckpt_path):
        log(f"Found trained checkpoint: {ckpt_path}; skipping training")
        return ckpt_path

    pad_shape = _pad_shape(max_size)
    train_loader = BatchLoader(CellDataset(data_dir, split="train", max_size=max_size),
                               cfg.batch_size, pad_shape, train=True, seed=cfg.seed,
                               process_shard=None if mesh is None else (mesh.rank, mesh.size),
                               device=device)
    # the full Evaluator enhances each image itself at native size, so its
    # loader skips the device preprocess
    val_loader = BatchLoader(CellDataset(data_dir, split="val", max_size=max_size),
                             cfg.batch_size, pad_shape, train=False,
                             preprocess=not use_full_evaluator_gate, device=device)

    state = _build_state(model_name, cfg, len(train_loader), dtype, device)
    if pretrained_dir and not resume:
        # the reference's smp encoder_weights="imagenet" (models.py:255-275)
        if required_weights(model_name):
            state, _ = initialize_pretrained(state, model_name, weights_dir=pretrained_dir,
                                             log=log)
        else:
            log(f"{model_name} has no pretrained encoders (reference trains it from "
                "scratch); ignoring --pretrained-dir")
    train_step = make_train_step(cfg, mesh)
    eval_step = None if use_full_evaluator_gate else make_eval_step(cfg)
    generator = torch.Generator(device=device).manual_seed(replica_seed(cfg.seed + 1, mesh))

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
    if mesh is not None:
        state = replicate_state(state, mesh)     # after any resume

    def persist(path, *args):
        # rank 0 writes; every rank waits for the write
        if lead:
            save_checkpoint(path, *args)
        if mesh is not None:
            mesh.barrier()

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
            val_iou = 0.0
            if lead:
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
            if mesh is not None:
                mesh.barrier()      # the others wait out rank 0's gate here
            val_iou, loss = _from_rank0(mesh, [val_iou, loss])

            if val_iou > best_miou:
                best_miou, best_loss = val_iou, loss
                patience_counter = 0
                persist(ckpt_path, state, epoch + 1, best_miou, best_loss, history)
                log(f"  saved best (mIoU {best_miou:.4f})")
            else:
                patience_counter += 1

        if patience_counter >= cfg.patience and epoch > cfg.early_stop_min_epoch:
            log(f"Early stopping at epoch {epoch + 1}")
            break

    # the final state always, for resume; best_model keeps the gate's choice
    final_epoch = min(epoch + 1, cfg.num_epochs) if cfg.num_epochs else 0
    persist(last_path, state, final_epoch, best_miou, best_loss, history)
    if not _from_rank0(mesh, [float(checkpoint_exists(ckpt_path))])[0]:
        # never validated above 0.0: the final state stands as the best
        persist(ckpt_path, state, final_epoch, best_miou, best_loss, history)
    return ckpt_path


def _collect_predictions(evaluator: Evaluator, loader, max_samples: int = 20):
    """Up to `max_samples` images with their masks, predictions, raw
    probabilities and per-image cell counts, for the chart suite
    (reference train_eval.py:1245-1319)."""
    images, gts, preds, names, probs_all, comparison = [], [], [], [], [], []
    for batch in loader:
        for item in batch["batch_items"][: batch["n_real"]]:
            img = np.asarray(item["image"], np.float32)
            pred = evaluator.predict_semantic_mask(img)
            _, pred_labels, _ = semantic_to_instances(pred)
            p_live = sum(1 for label in pred_labels if label == 0)
            p_dead = sum(1 for label in pred_labels if label == 1)
            g_live = sum(1 for label in item["instance_labels"] if label == 0)
            g_dead = sum(1 for label in item["instance_labels"] if label == 1)
            p_tot, g_tot = p_live + p_dead, g_live + g_dead
            p_via = p_live / p_tot * 100 if p_tot else 0.0
            g_via = g_live / g_tot * 100 if g_tot else 0.0
            comparison.append({
                "filename": item["image_id"],
                "gt_live_count": g_live, "gt_dead_count": g_dead,
                "gt_total_count": g_tot, "gt_viability": g_via,
                "pred_live_count": p_live, "pred_dead_count": p_dead,
                "pred_total_count": p_tot, "pred_viability": p_via,
                "live_error": p_live - g_live,
                "dead_error": p_dead - g_dead,
                "viability_error": p_via - g_via,
            })
            images.append(img)
            gts.append(np.asarray(item["semantic_mask"]))
            preds.append(pred)
            probs_all.append(evaluator.predict_probs(img))
            names.append(item["image_id"])
            if len(images) >= max_samples:
                return images, gts, preds, names, probs_all, comparison
    return images, gts, preds, names, probs_all, comparison


def _emit_prediction_charts(visualizer, model_name, images, gts, preds, names,
                            probs_all, comparison, log=print, data_dir="data"):
    """The figure suite of an evaluation (reference train_eval.py:1327-1525),
    each figure isolated so that one that fails does not stop the rest."""
    charts = [
        lambda: visualizer.plot_sample_grid(images, gts, preds, model_name,
                                            names, data_dir=data_dir),
        lambda: visualizer.plot_confusion_matrix(gts, preds, model_name),
        lambda: visualizer.visualize_predictions(images, gts, preds, names, model_name),
        lambda: visualizer.plot_cell_statistics(gts, preds, model_name),
        lambda: visualizer.plot_per_image_metrics(gts, preds, model_name),
        lambda: visualizer.plot_sample_predictions_grid(images, gts, preds, names,
                                                        model_name),
        lambda: visualizer.plot_error_analysis(gts, preds, model_name),
        lambda: visualizer.plot_class_distribution(gts, preds, model_name),
        lambda: visualizer.plot_feature_importance(gts, preds, images, model_name),
        lambda: visualizer.plot_roc_curves(probs_all, gts, model_name),
        lambda: visualizer.plot_pr_curves(probs_all, gts, model_name),
        lambda: visualizer.plot_boundary_accuracy(gts, preds, model_name),
        lambda: visualizer.plot_size_based_performance(gts, preds, model_name),
        lambda: visualizer.plot_calibration_curve(probs_all, gts, model_name),
        lambda: visualizer.create_paper_figures(images, gts, preds, model_name,
                                                names, data_dir=data_dir),
        lambda: visualizer.plot_cell_count_comparison(comparison, model_name),
    ]
    for fn in charts:
        try:
            fn()
        except Exception as e:  # the reference isolates every figure
            log(f"  warning: figure generation failed: {e}")


def _plot_history(history: Dict) -> Dict:
    """The checkpoint's history in the layout `plot_training_curves` and
    `plot_class_wise_metrics` take: per-epoch [background, live, dead] IoU
    and Dice, background 0."""
    n = len(history["train_loss"])
    live = history.get("val_live_iou", [])
    dead = history.get("val_dead_iou", [])
    dice = history.get("val_dice", [])
    return {
        "train_loss": history["train_loss"],
        "val_loss": history.get("val_loss", history["train_loss"]),
        "val_iou": [[0.0, live[i] if i < len(live) else 0.0,
                     dead[i] if i < len(dead) else 0.0] for i in range(n)],
        "val_dice": [([0.0] + list(dice[i])) if i < len(dice) else [0.0, 0.0, 0.0]
                     for i in range(n)],
    }


def evaluate_model(model_name: str, data_dir: str = "data",
                   checkpoint_path: Optional[str] = None, results_dir: str = "results",
                   max_size: int = 640, cfg: Optional[TrainConfig] = None,
                   dtype: torch.dtype = torch.bfloat16, generate_visualizations: bool = True,
                   tiled: bool = False, tile: int = 512, overlap: int = 64,
                   eval_batch_size: int = 1, log=print,
                   device: Optional[Union[str, torch.device]] = None) -> Dict:
    """Evaluate one model on the val split (reference train_eval.py:1165-1543)
    on `device` (None: the CUDA card), writing
    `results_dir/<model>/<model>_results.json` and, unless
    `generate_visualizations=False`, the figure suite beside it.

    The checkpoint is the port's checkpoint directory (`train.checkpoint`),
    a reference `.pth`/`.pt` file (`convert.torch_import`), or absent, which
    evaluates the seeded random weights with a warning.  Without
    matplotlib the figures are left out, with a warning.  `tiled=True`
    serves at full resolution through `tile` windows `overlap` pixels
    apart; `eval_batch_size > 1` sends same-shape images through the device
    together (the same metrics)."""
    device = resolve_device(device)
    cfg = cfg or get_preset(model_name, data_dir=data_dir)
    save_dir = os.path.join(results_dir, model_name)
    os.makedirs(save_dir, exist_ok=True)

    val_loader = BatchLoader(CellDataset(data_dir, split="val", max_size=max_size),
                             eval_batch_size, _pad_shape(max_size), train=False,
                             preprocess=False, device=device)
    state = _build_state(model_name, cfg, 1, dtype, device)
    ckpt = checkpoint_path or os.path.join("checkpoints", model_name, "best_model")
    meta: Dict = {}
    if checkpoint_exists(ckpt):
        state, meta = load_checkpoint(ckpt, state)
        log(f"Loaded checkpoint {ckpt} (best mIoU {meta.get('best_miou', 0.0):.4f})")
    elif os.path.isfile(ckpt) and ckpt.endswith((".pth", ".pt")):
        # a reference checkpoint (train_eval.py:1188-1202)
        state, report = load_torch_checkpoint(ckpt, state, model_name)
        meta = report["meta"]
        log(f"Imported torch checkpoint {ckpt}: {report['imported']}"
            f" (skipped: {report['skipped']})")
    else:
        log("WARNING: no checkpoint found; evaluating random init")

    evaluator = Evaluator(state.model, model_name, enable_tta=cfg.enable_tta, device=device,
                          tiled=tiled, tile=tile, overlap=overlap)
    results = evaluator.evaluate(val_loader)

    visualizer = None
    if generate_visualizations:
        try:
            visualizer = Visualizer(save_dir=save_dir)
        except ImportError as e:  # no matplotlib: the results without the figures
            log(f"  warning: figures not rendered: {e}")
    if visualizer is not None:
        history = meta.get("history", {})
        if history.get("train_loss"):
            plot_history = _plot_history(history)
            try:
                visualizer.plot_training_curves(plot_history, model_name)
                visualizer.plot_class_wise_metrics(plot_history, model_name)
                if history.get("learning_rate"):
                    visualizer.plot_learning_rate_schedule(history, model_name)
                if history.get("grad_norms"):
                    visualizer.plot_gradient_flow(history["grad_norms"], model_name)
            except Exception as e:
                log(f"  warning: history charts failed: {e}")

        log("Collecting predictions for visualization...")
        collected = _collect_predictions(evaluator, val_loader)
        if collected[0]:
            _emit_prediction_charts(visualizer, model_name, *collected, log=log,
                                    data_dir=data_dir)

    results_file = os.path.join(save_dir, f"{model_name}_results.json")
    with open(results_file, "w", encoding="utf-8") as f:
        json.dump(results, f, indent=2, ensure_ascii=False)
    log(f"Results saved to {results_file}")
    return results


def visualize_model(model_name: str, data_dir: str = "data",
                    checkpoint_dir: str = "checkpoints", checkpoint_path: Optional[str] = None,
                    results_dir: str = "results", regenerate_predictions: bool = False,
                    max_size: int = 640, max_samples: int = 20,
                    cfg: Optional[TrainConfig] = None, dtype: torch.dtype = torch.bfloat16,
                    log=print, device: Optional[Union[str, torch.device]] = None) -> Dict:
    """The figures alone (reference train_eval.py:1546-1801): the training
    history from the checkpoint, the saved results (returned), the
    prediction figures again when `regenerate_predictions` (served on
    `device`, None: the CUDA card), and the cross-model comparison of
    `results_dir`."""
    if regenerate_predictions:
        device = resolve_device(device)
    cfg = cfg or get_preset(model_name, data_dir=data_dir)
    save_dir = os.path.join(results_dir, model_name)
    os.makedirs(save_dir, exist_ok=True)
    visualizer = Visualizer(save_dir=save_dir)

    # 1. training history from the checkpoint (train_eval.py:1566-1617)
    ckpt = checkpoint_path or os.path.join(checkpoint_dir, model_name, "best_model")
    if checkpoint_exists(ckpt):
        with open(os.path.join(ckpt, "meta.json"), encoding="utf-8") as f:
            history = json.load(f).get("history", {})
        if history.get("train_loss"):
            plot_history = _plot_history(history)
            visualizer.plot_training_curves(plot_history, model_name)
            visualizer.plot_class_wise_metrics(plot_history, model_name)
            visualizer.save_training_history_csv(history, model_name)
        if history.get("learning_rate"):
            visualizer.plot_learning_rate_schedule(history, model_name)
        if history.get("grad_norms"):
            visualizer.plot_gradient_flow(history["grad_norms"], model_name)
    else:
        log(f"No checkpoint found at {ckpt}")

    # 2. the saved evaluation results (train_eval.py:1621-1630)
    results_file = os.path.join(save_dir, f"{model_name}_results.json")
    results: Dict = {}
    if os.path.exists(results_file):
        log(f"Loading evaluation results: {results_file}")
        with open(results_file, encoding="utf-8") as f:
            results = json.load(f)
        log("Evaluation results loaded")
    else:
        log(f"No evaluation results file: {results_file}")

    # 3. the prediction figures again (train_eval.py:1632-1787)
    if regenerate_predictions and checkpoint_exists(ckpt):
        loader = BatchLoader(CellDataset(data_dir, split="val", max_size=max_size), 1,
                             _pad_shape(max_size), train=False, preprocess=False,
                             device=device)
        state, _ = load_checkpoint(ckpt, _build_state(model_name, cfg, 1, dtype, device))
        evaluator = Evaluator(state.model, model_name, enable_tta=cfg.enable_tta,
                              device=device)
        collected = _collect_predictions(evaluator, loader, max_samples)
        if collected[0]:
            _emit_prediction_charts(visualizer, model_name, *collected, log=log,
                                    data_dir=data_dir)

    # 4. cross-model comparison from the aggregated results (train_eval.py:1794-1799)
    Visualizer(save_dir=results_dir).plot_comprehensive_comparison_from_csv()
    return results


def predict_model(model_name: str, images_dir: str, checkpoint_path: Optional[str] = None,
                  results_dir: str = "results", max_size: int = 640,
                  cfg: Optional[TrainConfig] = None, dtype: torch.dtype = torch.bfloat16,
                  tiled: bool = False, tile: int = 512, overlap: int = 64,
                  batch_size: int = 8, log=print,
                  device: Optional[Union[str, torch.device]] = None) -> Dict:
    """Label-free inference over the *.jpg/*.jpeg/*.png files of a
    directory, on `device` (None: the CUDA card): enhance, TTA, threshold
    cascade, instances and viability, writing `<stem>_mask.png`,
    `<stem>_overlay.png` and `predictions.csv` (filename, live/dead counts
    and pixels, viability %) into `results_dir/<model>/predictions`.

    Images are grouped by their size after the resize policy (the longer
    side at most `max_size`, both snapped to multiples of 32), read from
    the headers alone; each group is decoded and served `batch_size` at a
    time, one forward per chunk (one per image when `tiled`, or for a
    chunk of one)."""
    from PIL import Image

    device = resolve_device(device)
    cfg = cfg or get_preset(model_name)
    save_dir = os.path.join(results_dir, model_name, "predictions")
    os.makedirs(save_dir, exist_ok=True)

    names = sorted(f for f in os.listdir(images_dir)
                   if f.lower().endswith((".jpg", ".jpeg", ".png")))
    if not names:
        raise ValueError(f"no images found in {images_dir}")

    state = _build_state(model_name, cfg, 1, dtype, device)
    ckpt = checkpoint_path or os.path.join("checkpoints", model_name, "best_model")
    if checkpoint_exists(ckpt):
        state, _ = load_checkpoint(ckpt, state)
        log(f"loaded checkpoint {ckpt}")
    else:
        log(f"WARNING: no checkpoint at {ckpt}; predicting with random init")
    evaluator = Evaluator(state.model, model_name, enable_tta=cfg.enable_tta, device=device,
                          tiled=tiled, tile=tile, overlap=overlap, verbose=False)

    groups: Dict[tuple, list] = {}
    for name in names:
        with Image.open(os.path.join(images_dir, name)) as im:
            w0, h0 = im.size
        groups.setdefault(snap_to_multiple(h0, w0, max_size), []).append(name)

    def decode(name: str, shape: tuple) -> np.ndarray:
        arr = _read_rgb(os.path.join(images_dir, name))
        if shape != arr.shape[:2]:
            arr = _resize_image(arr, (shape[1], shape[0]))
        return arr.astype(np.float32) / 255.0

    results: Dict[str, dict] = {}
    for shape, group in groups.items():
        for i in range(0, len(group), batch_size):
            chunk = group[i:i + batch_size]
            imgs = [decode(n, shape) for n in chunk]
            if tiled or len(chunk) == 1:
                masks = [np.asarray(evaluator.predict_semantic_mask(a)) for a in imgs]
            else:
                masks = list(evaluator.predict_semantic_masks(np.stack(imgs)))
            for name, img, mask in zip(chunk, imgs, masks):
                _, inst_labels, _ = semantic_to_instances(mask)
                live = sum(1 for label in inst_labels if label == 0)
                dead = sum(1 for label in inst_labels if label == 1)
                viability = 100.0 * live / max(live + dead, 1)
                stem = os.path.splitext(name)[0]
                colored = CLASS_COLORS[np.clip(mask, 0, 2)]
                Image.fromarray((colored * 255).astype(np.uint8)).save(
                    os.path.join(save_dir, f"{stem}_mask.png"))
                overlay = np.clip(img * 0.5 + colored * 0.5, 0, 1)
                Image.fromarray((overlay * 255).astype(np.uint8)).save(
                    os.path.join(save_dir, f"{stem}_overlay.png"))
                results[name] = {
                    "filename": name,
                    "live_count": live,
                    "dead_count": dead,
                    "total_count": live + dead,
                    "viability_percent": round(viability, 2),
                    "live_pixels": int((mask == 1).sum()),
                    "dead_pixels": int((mask == 2).sum()),
                }
                log(f"{name}: live={live} dead={dead} viability={viability:.1f}%")

    rows = [results[name] for name in names]
    with open(os.path.join(save_dir, "predictions.csv"), "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    log(f"predictions written to {save_dir}")
    return {"predictions": rows, "save_dir": save_dir}


def train_and_evaluate(model_name: str, data_dir: str = "data", num_epochs: int = 50,
                       skip_training: bool = False, **kwargs) -> Dict:
    """`train_model`, then `evaluate_model` of its best checkpoint on the
    same device (reference train_eval.py:1024-1033)."""
    ckpt = train_model(model_name, data_dir, num_epochs, skip_training=skip_training,
                       **kwargs)
    return evaluate_model(model_name, data_dir, checkpoint_path=ckpt,
                          device=kwargs.get("device"))
