"""Visualizer: the reference's chart suite, ported from
`enhanced_unet_tpu/viz/visualizer.py` (the same methods, output file names
and figures; PNG and SVG at dpi 300, reference visualization.py:83-119).
Per-image metrics come from `enhanced_unet_tpu_torch.metrics.semantic`.

matplotlib (and seaborn, where installed) is imported when the first
`Visualizer` is built, not when this module is imported: the serving entry
points take `CLASS_COLORS` from here and never need matplotlib.

Charts (reference line refs in each method):
training curves, LR schedule, class-wise metric curves, sample grids,
confusion matrix, prediction overlays, cell statistics, per-image metric
distributions, error analysis, class distribution, spatial accuracy,
ROC/PR/calibration curves, boundary & size-stratified IoU, gradient flow,
4 paper figures, cell-count comparison (+CSV), 12-figure cross-model
comparison suite, CSV loaders.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from enhanced_unet_tpu_torch.metrics.semantic import (
    calculate_dice,
    calculate_iou,
    calculate_semantic_metrics,
)

# set by _import_matplotlib() when the first Visualizer is built
plt = None
sns = None
_cjk = None

# CJK figure labels (the paper fig1 column titles keep the reference's
# Chinese strings, main.py:39-72 probes fonts for the same reason): use a
# CJK-capable font when one is installed, otherwise silence the per-glyph
# missing-font warnings; the figures still render, titles as tofu boxes.
_CJK_CANDIDATES = ("Noto Sans CJK SC", "Noto Sans SC", "WenQuanYi Micro Hei",
                   "SimHei", "Source Han Sans SC")


def _import_matplotlib() -> None:
    """Import matplotlib on the Agg backend, seaborn if installed (the
    reference styles its heatmaps with it), and pick a CJK font."""
    global plt, sns, _cjk
    if plt is not None:
        return
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as pyplot

    try:
        import seaborn
    except ImportError:
        seaborn = None
    available = {f.name for f in matplotlib.font_manager.fontManager.ttflist}
    cjk = next((n for n in _CJK_CANDIDATES if n in available), None)
    if cjk is not None:
        pyplot.rcParams["font.sans-serif"] = [cjk] + pyplot.rcParams["font.sans-serif"]
        pyplot.rcParams["axes.unicode_minus"] = False
    else:
        import warnings

        warnings.filterwarnings(
            "ignore", message=r"Glyph \d+ .* missing from font", module=".*")
    plt, sns, _cjk = pyplot, seaborn, cjk


CLASS_NAMES = ("background", "live", "dead")
# bg black, live green, dead red (reference _colorize_mask,
# visualization.py:2194-2213)
CLASS_COLORS = np.array(
    [[0.0, 0.0, 0.0], [0.0, 0.8, 0.2], [0.9, 0.1, 0.1]], dtype=np.float32
)


def _to_img(img) -> np.ndarray:
    """Accept HWC / CHW float or uint8; return HWC float in [0,1]."""
    a = np.asarray(img)
    if a.ndim == 3 and a.shape[0] in (1, 3) and a.shape[0] < a.shape[-1]:
        a = np.transpose(a, (1, 2, 0))
    a = a.astype(np.float32)
    if a.max() > 1.5:
        a = a / 255.0
    return np.clip(a, 0, 1)


class Visualizer:
    """Chart generator writing into save_dir (reference visualization.py:20)."""

    def __init__(self, save_dir: str = "results"):
        _import_matplotlib()
        self.save_dir = save_dir
        os.makedirs(save_dir, exist_ok=True)

    # ------------------------------------------------------------------ io
    def _save_figure(self, fig, filename: str, dpi: int = 300):
        """PNG + SVG dumps (visualization.py:83-119)."""
        import warnings

        with warnings.catch_warnings():
            if _cjk is None:  # no CJK font installed: tofu boxes, no spam
                warnings.filterwarnings(
                    "ignore", message=r"Glyph \d+ .* missing from font")
            for ext in ("png", "svg"):
                fig.savefig(
                    os.path.join(self.save_dir, f"{filename}.{ext}"),
                    dpi=dpi,
                    bbox_inches="tight",
                )
        plt.close(fig)

    def _colorize_mask(self, mask) -> np.ndarray:
        mask = np.asarray(mask).astype(np.int32)
        return CLASS_COLORS[np.clip(mask, 0, 2)]

    mask_to_color = _colorize_mask  # reference alias (visualization.py:391)

    # ------------------------------------------------------- training curves
    def plot_training_curves(self, history: Dict, model_name: str):
        """Loss + per-class IoU/Dice curves (visualization.py:121-195).

        Documented deviation: the reference's second panel is an "Accuracy
        Curve" fed all-zero placeholders (train_eval.py:1334-1335); the
        fourth panel here plots cell mIoU instead of reproducing that
        zero plot."""
        fig, axes = plt.subplots(2, 2, figsize=(14, 10))
        fig.suptitle(f"{model_name} training", fontsize=14, fontweight="bold")
        ax = axes[0, 0]
        ax.plot(history.get("train_loss", []), label="train loss")
        ax.plot(history.get("val_loss", []), label="val loss", ls="--")
        ax.set_xlabel("epoch"); ax.set_ylabel("loss"); ax.legend(); ax.grid(alpha=0.3)
        ax = axes[0, 1]
        val_iou = np.asarray(history.get("val_iou", []), dtype=float)
        if val_iou.size:
            for c in range(min(3, val_iou.shape[1])):
                ax.plot(val_iou[:, c], label=f"{CLASS_NAMES[c]} IoU")
        ax.set_xlabel("epoch"); ax.set_ylabel("IoU"); ax.legend(); ax.grid(alpha=0.3)
        ax = axes[1, 0]
        val_dice = np.asarray(history.get("val_dice", []), dtype=float)
        if val_dice.size:
            for c in range(min(3, val_dice.shape[1])):
                ax.plot(val_dice[:, c], label=f"{CLASS_NAMES[c]} Dice")
        ax.set_xlabel("epoch"); ax.set_ylabel("Dice"); ax.legend(); ax.grid(alpha=0.3)
        ax = axes[1, 1]
        if val_iou.size:
            ax.plot(val_iou[:, 1:].mean(axis=1), label="cell mIoU", color="tab:purple")
        ax.set_xlabel("epoch"); ax.set_ylabel("mIoU"); ax.legend(); ax.grid(alpha=0.3)
        fig.tight_layout()
        self._save_figure(fig, f"{model_name}_training_curves")

    def plot_learning_rate_schedule(self, history: Dict, model_name: str):
        """LR-vs-epoch (visualization.py:1546-1565)."""
        lrs = history.get("learning_rate", history if isinstance(history, list) else [])
        fig, ax = plt.subplots(figsize=(8, 5))
        ax.plot(lrs, marker=".")
        ax.set_xlabel("epoch"); ax.set_ylabel("learning rate"); ax.set_yscale("log")
        ax.set_title(f"{model_name} LR schedule"); ax.grid(alpha=0.3)
        self._save_figure(fig, f"{model_name}_learning_rate")

    def plot_class_wise_metrics(self, history: Dict, model_name: str):
        """Per-class metric curves, one subplot PER CLASS with IoU+Dice
        lines as in the reference (visualization.py:1201-1250)."""
        iou = np.asarray(history.get("val_iou", []), dtype=float)
        dice = np.asarray(history.get("val_dice", []), dtype=float)
        fig, axes = plt.subplots(1, 3, figsize=(18, 6))
        for c, ax in enumerate(axes):
            if iou.size and c < iou.shape[1]:
                ax.plot(iou[:, c], "o-", label="IoU", markersize=6)
            if dice.size and c < dice.shape[1]:
                ax.plot(dice[:, c], "s-", label="Dice", markersize=6)
            ax.set_xlabel("Epoch", fontsize=12, fontweight="bold")
            ax.set_ylabel("Score", fontsize=12, fontweight="bold")
            ax.set_title(f"{model_name} - {CLASS_NAMES[c]} Metrics",
                         fontsize=14, fontweight="bold")
            ax.legend(frameon=True, shadow=True)
            ax.grid(True, alpha=0.3, linestyle="--")
            ax.spines["top"].set_visible(False)
            ax.spines["right"].set_visible(False)
        fig.tight_layout()
        self._save_figure(fig, f"{model_name}_class_wise_metrics")

    def save_training_history_csv(self, history: Dict, model_name: str):
        """history -> CSV with the reference's column schema
        (visualization.py:1518-1544: Epoch, Train_Loss, Val_Loss,
        Train_Acc, Val_Acc, then per-class IoU/Dice when present), plus
        any extra history series appended after (this trainer records
        more: learning_rate, epoch_time_sec, images_per_sec, ...)."""
        path = os.path.join(self.save_dir, f"{model_name}_training_history.csv")
        n = len(history.get("train_loss", []))

        def col(k, default=0.0):
            v = history.get(k, [])
            return [v[i] if i < len(v) else default for i in range(n)]

        data = {
            "Epoch": list(range(1, n + 1)),
            "Train_Loss": col("train_loss"),
            "Val_Loss": col("val_loss"),
            "Train_Acc": col("train_acc"),
            "Val_Acc": col("val_acc"),
        }
        val_iou = history.get("val_iou", [])
        val_dice = history.get("val_dice", [])
        if len(val_iou) > 0:
            viou = np.asarray(
                [list(r) + [0.0] * (3 - len(r)) for r in val_iou], float)
            vdice = np.asarray(
                [list(r) + [0.0] * (3 - len(r)) for r in val_dice], float)
            for i, cname in enumerate(CLASS_NAMES):
                data[f"{cname}_IoU"] = list(viou[:, i]) + [0.0] * (
                    n - len(viou))
                data[f"{cname}_Dice"] = list(vdice[:, i]) + [0.0] * (
                    n - len(vdice))
        covered = {"train_loss", "val_loss", "train_acc", "val_acc",
                   "val_iou", "val_dice"}
        for k, v in history.items():
            if k not in covered and isinstance(v, list) and not any(
                    isinstance(e, (list, tuple, dict)) for e in v):
                data[k] = [v[i] if i < len(v) else "" for i in range(n)]
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(list(data))
            for i in range(n):
                w.writerow([data[k][i] for k in data])
        return path

    def plot_gradient_flow(self, grad_norms: Dict[str, float], model_name: str):
        """Per-parameter gradient magnitudes (visualization.py:1567-1600).

        Takes {param_name: mean_abs_grad}, as `train.trainer.compute_grad_norms`
        gives it (named parameters, not module hooks).
        """
        names = list(grad_norms)
        vals = [float(grad_norms[n]) for n in names]
        fig, ax = plt.subplots(figsize=(max(8, len(names) * 0.25), 5))
        ax.bar(range(len(vals)), vals, alpha=0.7)
        ax.set_xticks(range(len(names)))
        ax.set_xticklabels(names, rotation=90, fontsize=5)
        ax.set_ylabel("mean |grad|"); ax.set_yscale("log")
        ax.set_title(f"{model_name} gradient flow")
        fig.tight_layout()
        self._save_figure(fig, f"{model_name}_gradient_flow")

    # --------------------------------------------------------- sample grids
    def plot_sample_grid(self, images, masks_true, masks_pred, model_name: str,
                         filenames: Optional[Sequence[str]] = None,
                         max_rows: int = 8, data_dir: str = "data"):
        """The reference's FOUR-column grid (visualization.py:197-292):
        [pre-preprocessing original | preprocessed image | GT | prediction],
        up to 8 rows at figsize (20, 5n).

        Column 1 loads the raw image straight from `data_dir/<filename>`
        when available (visualization.py:207-222); otherwise it falls back
        to the reference's de-normalization approximation of the
        preprocessed tensor (visualization.py:225-241)."""
        n = min(len(images), max_rows)
        fig, axes = plt.subplots(n, 4, figsize=(20, 5 * n), squeeze=False)
        for i in range(n):
            shown = _to_img(images[i])
            original = None
            if filenames and i < len(filenames):
                path = os.path.join(data_dir, str(filenames[i]))
                if os.path.exists(path):
                    try:
                        from PIL import Image

                        original = np.asarray(
                            Image.open(path).convert("RGB"),
                            dtype=np.float32) / 255.0
                    except Exception:
                        original = None
            if original is None:
                # de-normalization approximation (visualization.py:225-241;
                # our pipeline keeps [0,1] images, so this is the identity
                # clip rather than the torch mean/std inversion)
                original = shown
            axes[i, 0].imshow(original)
            axes[i, 0].set_title(f"Sample {i + 1} - original",
                                 fontsize=12, fontweight="bold")
            axes[i, 1].imshow(shown)
            axes[i, 1].set_title("preprocessed", fontsize=12,
                                 fontweight="bold")
            axes[i, 2].imshow(self._colorize_mask(masks_true[i]))
            axes[i, 2].set_title("ground truth", fontsize=12,
                                 fontweight="bold")
            axes[i, 3].imshow(self._colorize_mask(masks_pred[i]))
            m = calculate_semantic_metrics(
                np.asarray(masks_pred[i]), np.asarray(masks_true[i])
            )
            axes[i, 3].set_title(f"prediction (mIoU {m['sem_mean_iou']:.3f})",
                                 fontsize=12, fontweight="bold")
            for j in range(4):
                axes[i, j].axis("off")
        fig.tight_layout()
        self._save_figure(fig, f"{model_name}_sample_grid")

    def plot_sample_predictions_grid(self, images, masks_true, masks_pred,
                                     filenames, model_name: str,
                                     num_samples: int = 16):
        """Up-to-16-sample grid of prediction overlays, 4 per row
        (visualization.py:1360-1401).  The reference saves it under the
        same `{model}_sample_grid` filename as plot_sample_grid and calls
        it LATER in the eval flow (train_eval.py:1376 then 1421), so this
        overlay grid is the artifact that survives on disk."""
        num_samples = min(num_samples, len(images))
        rows = max(int(np.ceil(num_samples / 4)), 1)
        fig, axes = plt.subplots(rows, 4, figsize=(20, 5 * rows),
                                 squeeze=False)
        for i in range(num_samples):
            img = _to_img(images[i])
            colored = self._colorize_mask(masks_pred[i])
            overlay = np.clip(img * 0.5 + colored * 0.5, 0, 1)
            ax = axes[i // 4, i % 4]
            ax.imshow(overlay)
            ax.set_title(f"Sample {i + 1}", fontsize=10, fontweight="bold")
            ax.axis("off")
        for i in range(num_samples, rows * 4):
            axes[i // 4, i % 4].axis("off")
        fig.suptitle(f"{model_name} - Sample Predictions", fontsize=16,
                     fontweight="bold")
        fig.tight_layout()
        self._save_figure(fig, f"{model_name}_sample_grid")

    def visualize_predictions(self, images, masks_true, masks_pred,
                              filenames, model_name: str,
                              num_samples: int = 8):
        """The reference's per-sample 4-column prediction figure
        (visualization.py:342-389): [original | GT | prediction |
        0.6/0.4 overlay], up to 8 rows."""
        n = min(num_samples, len(images))
        fig, axes = plt.subplots(n, 4, figsize=(16, 4 * n), squeeze=False)
        for i in range(n):
            img = _to_img(images[i])
            axes[i, 0].imshow(img)
            axes[i, 0].set_title(f"Original Image\n{filenames[i]}",
                                 fontsize=10, fontweight="bold")
            axes[i, 1].imshow(self._colorize_mask(masks_true[i]))
            axes[i, 1].set_title("Ground Truth", fontsize=10,
                                 fontweight="bold")
            pred_colored = self._colorize_mask(masks_pred[i])
            axes[i, 2].imshow(pred_colored)
            axes[i, 2].set_title("Prediction", fontsize=10, fontweight="bold")
            axes[i, 3].imshow(np.clip(img * 0.6 + pred_colored * 0.4, 0, 1))
            axes[i, 3].set_title("Overlay", fontsize=10, fontweight="bold")
            for j in range(4):
                axes[i, j].axis("off")
        fig.tight_layout()
        self._save_figure(fig, f"{model_name}_predictions")

    # ----------------------------------------------------------- statistics
    def plot_confusion_matrix(self, masks_true, masks_pred, model_name: str):
        """The reference's dual-heatmap confusion figure (visualization.py:
        294-340): absolute counts (Blues) and row-normalized percentages
        (Greens) side by side, seaborn-annotated; 255=unlabeled filtered."""
        cm = np.zeros((3, 3), dtype=np.int64)
        for t, p in zip(masks_true, masks_pred):
            t = np.asarray(t).ravel(); p = np.asarray(p).ravel()
            valid = (t != 255) & (p != 255)
            t = np.clip(t[valid], 0, 2); p = np.clip(p[valid], 0, 2)
            cm += np.bincount(t * 3 + p, minlength=9).reshape(3, 3)
        norm = cm.astype(np.float64) / (cm.sum(axis=1, keepdims=True) + 1e-6)
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(16, 7))
        if sns is not None:
            sns.heatmap(cm, annot=True, fmt="d", cmap="Blues",
                        xticklabels=CLASS_NAMES, yticklabels=CLASS_NAMES,
                        cbar_kws={"label": "Count"}, ax=ax1, square=True)
            sns.heatmap(norm, annot=True, fmt=".2%", cmap="Greens",
                        xticklabels=CLASS_NAMES, yticklabels=CLASS_NAMES,
                        cbar_kws={"label": "Percentage"}, ax=ax2, square=True)
        else:  # plain-matplotlib fallback
            for ax, mat, cmap in ((ax1, cm, "Blues"), (ax2, norm, "Greens")):
                im = ax.imshow(mat, cmap=cmap)
                for i in range(3):
                    for j in range(3):
                        v = mat[i, j]
                        ax.text(j, i, f"{v:d}" if mat is cm else f"{v:.2%}",
                                ha="center", va="center", fontsize=9)
                ax.set_xticks(range(3)); ax.set_xticklabels(CLASS_NAMES)
                ax.set_yticks(range(3)); ax.set_yticklabels(CLASS_NAMES)
                fig.colorbar(im, ax=ax)
        for ax, kind in ((ax1, "Counts"), (ax2, "Normalized")):
            ax.set_xlabel("Predicted Class", fontsize=12, fontweight="bold")
            ax.set_ylabel("True Class", fontsize=12, fontweight="bold")
            ax.set_title(f"{model_name} - Confusion Matrix ({kind})",
                         fontsize=14, fontweight="bold")
        fig.tight_layout()
        self._save_figure(fig, f"{model_name}_confusion_matrix")

    def plot_cell_statistics(self, masks_true, masks_pred, model_name: str):
        """The reference's 2x2 cell-statistics panel (visualization.py:
        404-494): mean per-class pixel-count bars GT vs pred, live-ratio
        scatter with the y=x perfect-prediction line, GT pixel-count
        histograms, and per-class |pred-GT| pixel-error boxplots."""
        true_counts = np.array([[np.sum(np.asarray(t) == c) for c in range(3)]
                                for t in masks_true], dtype=np.float64)
        pred_counts = np.array([[np.sum(np.asarray(p) == c) for c in range(3)]
                                for p in masks_pred], dtype=np.float64)
        fig, axes = plt.subplots(2, 2, figsize=(15, 12))
        # class distribution comparison (mean pixel counts)
        x = np.arange(3)
        w = 0.35
        axes[0, 0].bar(x - w / 2, true_counts.mean(axis=0), w,
                       label="Ground Truth", alpha=0.8)
        axes[0, 0].bar(x + w / 2, pred_counts.mean(axis=0), w,
                       label="Prediction", alpha=0.8)
        axes[0, 0].set_xticks(x)
        axes[0, 0].set_xticklabels(CLASS_NAMES, rotation=15, ha="right")
        axes[0, 0].set_xlabel("Class", fontsize=12, fontweight="bold")
        axes[0, 0].set_ylabel("Average Pixel Count", fontsize=12,
                              fontweight="bold")
        axes[0, 0].set_title("Class Distribution Comparison", fontsize=14,
                             fontweight="bold")
        axes[0, 0].legend(frameon=True, shadow=True)
        # live-ratio scatter vs perfect prediction
        lt, dt = true_counts[:, 1], true_counts[:, 2]
        lp, dp_ = pred_counts[:, 1], pred_counts[:, 2]
        axes[0, 1].scatter(lt / (lt + dt + 1e-6), lp / (lp + dp_ + 1e-6),
                           alpha=0.6, s=50)
        axes[0, 1].plot([0, 1], [0, 1], "--", linewidth=2,
                        label="Perfect Prediction")
        axes[0, 1].set_xlabel("True Live Cell Ratio", fontsize=12,
                              fontweight="bold")
        axes[0, 1].set_ylabel("Predicted Live Cell Ratio", fontsize=12,
                              fontweight="bold")
        axes[0, 1].set_title("Live Cell Ratio Prediction", fontsize=14,
                             fontweight="bold")
        axes[0, 1].legend(frameon=True, shadow=True)
        # GT pixel-count histograms
        axes[1, 0].hist(lt, bins=20, alpha=0.6, label="Live Cells (GT)")
        axes[1, 0].hist(dt, bins=20, alpha=0.6, label="Dead Cells (GT)")
        axes[1, 0].set_xlabel("Pixel Count", fontsize=12, fontweight="bold")
        axes[1, 0].set_ylabel("Frequency", fontsize=12, fontweight="bold")
        axes[1, 0].set_title("Cell Count Distribution", fontsize=14,
                             fontweight="bold")
        axes[1, 0].legend(frameon=True, shadow=True)
        # per-class absolute pixel-error boxplots
        axes[1, 1].boxplot([np.abs(lp - lt), np.abs(dp_ - dt)],
                           tick_labels=["Live Cells", "Dead Cells"],
                           patch_artist=True)
        axes[1, 1].set_ylabel("Prediction Error (Pixel Count)", fontsize=12,
                              fontweight="bold")
        axes[1, 1].set_title("Prediction Error Distribution", fontsize=14,
                             fontweight="bold")
        for ax in axes.flat:
            ax.grid(True, alpha=0.3, axis="y", linestyle="--")
            ax.spines["top"].set_visible(False)
            ax.spines["right"].set_visible(False)
        fig.tight_layout()
        self._save_figure(fig, f"{model_name}_cell_statistics")

    def plot_per_image_metrics(self, masks_true, masks_pred, model_name: str):
        """The reference's three per-image histograms (visualization.py:
        1274-1357): mean-over-present-classes IoU, Dice (union>0 classes
        only), and pixel accuracy, each with a mean line; 255 excluded."""
        if not len(masks_true) or not len(masks_pred):
            return
        ious, dices, accs = [], [], []
        for t, p in zip(masks_true, masks_pred):
            t = np.asarray(t); p = np.asarray(p)
            valid = t != 255
            if valid.sum() == 0:
                continue
            tv, pv = t[valid], p[valid]
            accs.append((tv == pv).mean())
            cious, cdices = [], []
            for c in range(3):
                tc, pc = tv == c, pv == c
                union = (tc | pc).sum()
                if union > 0:
                    inter = (tc & pc).sum()
                    cious.append(inter / union)
                    cdices.append(2 * inter / (tc.sum() + pc.sum()))
            if cious:
                ious.append(np.mean(cious)); dices.append(np.mean(cdices))
        fig, axes = plt.subplots(1, 3, figsize=(18, 5))
        panels = ((ious, "IoU Score", "IoU Distribution"),
                  (dices, "Dice Score", "Dice Distribution"),
                  (accs, "Accuracy", "Accuracy Distribution"))
        for ax, (vals, xlabel, title) in zip(axes, panels):
            ax.hist(vals, bins=20, alpha=0.7, edgecolor="black")
            if vals:
                ax.axvline(np.mean(vals), color="tab:red", linestyle="--",
                           linewidth=2, label=f"Mean = {np.mean(vals):.3f}")
                ax.legend(frameon=True, shadow=True)
            ax.set_xlabel(xlabel, fontsize=12, fontweight="bold")
            ax.set_ylabel("Frequency", fontsize=12, fontweight="bold")
            ax.set_title(f"{model_name} - {title}", fontsize=14,
                         fontweight="bold")
            ax.grid(True, alpha=0.3, axis="y", linestyle="--")
            ax.spines["top"].set_visible(False)
            ax.spines["right"].set_visible(False)
        fig.tight_layout()
        self._save_figure(fig, f"{model_name}_per_image_metrics")

    def plot_error_analysis(self, masks_true, masks_pred, model_name: str):
        """The reference's 2x2 error-analysis panel (visualization.py:
        1403-1516): overall per-image error-rate histogram with mean line,
        class-wise mean error bars with value labels, per-class error-rate
        boxplots, and a row-normalized confusion heatmap; 255 = unlabeled
        is excluded everywhere."""
        num_classes = 3
        all_errors = []
        class_errors = [[] for _ in range(num_classes)]
        confusion = np.zeros((num_classes, num_classes))
        for t, p in zip(masks_true, masks_pred):
            t = np.asarray(t); p = np.asarray(p)
            valid = t != 255
            if valid.sum() == 0:
                continue
            all_errors.append(((t != p) & valid).sum() / valid.sum())
            for c in range(num_classes):
                cm = (t == c) & valid
                if cm.sum() > 0:
                    class_errors[c].append((t[cm] != p[cm]).sum() / cm.sum())
            for tc in range(num_classes):
                for pc in range(num_classes):
                    confusion[tc, pc] += ((t == tc) & (p == pc) & valid).sum()

        fig, axes = plt.subplots(2, 2, figsize=(15, 12))
        # overall error histogram + mean line
        axes[0, 0].hist(all_errors, bins=20, alpha=0.7, edgecolor="black")
        if all_errors:
            axes[0, 0].axvline(np.mean(all_errors), color="tab:red",
                               linestyle="--", linewidth=2,
                               label=f"Mean = {np.mean(all_errors):.3f}")
            axes[0, 0].legend(frameon=True, shadow=True)
        axes[0, 0].set_xlabel("Error Rate", fontsize=12, fontweight="bold")
        axes[0, 0].set_ylabel("Frequency", fontsize=12, fontweight="bold")
        axes[0, 0].set_title("Overall Error Distribution", fontsize=14,
                             fontweight="bold")
        # class-wise mean error bars with value labels
        means = [np.mean(e) if e else 0 for e in class_errors]
        x = np.arange(num_classes)
        bars = axes[0, 1].bar(x, means, alpha=0.7, edgecolor="black",
                              color=[CLASS_COLORS[c] * 0.8 + 0.2
                                     for c in range(num_classes)])
        axes[0, 1].set_xticks(x)
        axes[0, 1].set_xticklabels(CLASS_NAMES, rotation=15, ha="right")
        axes[0, 1].set_xlabel("Class", fontsize=12, fontweight="bold")
        axes[0, 1].set_ylabel("Mean Error Rate", fontsize=12,
                              fontweight="bold")
        axes[0, 1].set_title("Class-wise Error Rates", fontsize=14,
                             fontweight="bold")
        for bar, v in zip(bars, means):
            axes[0, 1].text(bar.get_x() + bar.get_width() / 2,
                            bar.get_height(), f"{v:.3f}", ha="center",
                            va="bottom", fontweight="bold")
        # per-class boxplots
        valid_e = [e for e in class_errors if e]
        valid_l = [CLASS_NAMES[i] for i, e in enumerate(class_errors) if e]
        if valid_e:
            axes[1, 0].boxplot(valid_e, tick_labels=valid_l,
                               patch_artist=True)
        else:
            axes[1, 0].text(0.5, 0.5, "No error data available",
                            ha="center", va="center",
                            transform=axes[1, 0].transAxes)
        axes[1, 0].set_ylabel("Error Rate", fontsize=12, fontweight="bold")
        axes[1, 0].set_title("Error Rate Distribution by Class",
                             fontsize=14, fontweight="bold")
        # row-normalized confusion heatmap
        norm = confusion / (confusion.sum(axis=1, keepdims=True) + 1e-10)
        im = axes[1, 1].imshow(norm, cmap="YlOrRd", aspect="auto")
        axes[1, 1].set_xticks(x); axes[1, 1].set_yticks(x)
        axes[1, 1].set_xticklabels(CLASS_NAMES, rotation=15, ha="right")
        axes[1, 1].set_yticklabels(CLASS_NAMES)
        for i in range(num_classes):
            for j in range(num_classes):
                axes[1, 1].text(j, i, f"{norm[i, j]:.2f}", ha="center",
                                va="center",
                                color="white" if norm[i, j] > 0.5 else "black")
        axes[1, 1].set_xlabel("Predicted Class", fontsize=12,
                              fontweight="bold")
        axes[1, 1].set_ylabel("True Class", fontsize=12, fontweight="bold")
        axes[1, 1].set_title("Normalized Confusion Heatmap", fontsize=14,
                             fontweight="bold")
        plt.colorbar(im, ax=axes[1, 1], label="Proportion")
        for ax in (axes[0, 0], axes[0, 1], axes[1, 0]):
            ax.grid(True, alpha=0.3, axis="y", linestyle="--")
            ax.spines["top"].set_visible(False)
            ax.spines["right"].set_visible(False)
        fig.tight_layout()
        self._save_figure(fig, f"{model_name}_error_analysis")

    def plot_class_distribution(self, masks_true, masks_pred, model_name: str):
        """The reference's two-panel class distribution (visualization.py:
        1629-1684): absolute pixel counts and percentages, GT vs pred."""
        gt = np.zeros(3); pr = np.zeros(3)
        for t, p in zip(masks_true, masks_pred):
            gt += np.bincount(np.clip(np.asarray(t).ravel(), 0, 3),
                              minlength=4)[:3]
            pr += np.bincount(np.clip(np.asarray(p).ravel(), 0, 3),
                              minlength=4)[:3]
        x = np.arange(3)
        w = 0.35
        fig, axes = plt.subplots(1, 2, figsize=(14, 6))
        panels = (
            (gt, pr, "Pixel Count", "Class Distribution Comparison"),
            (gt / (gt.sum() + 1e-6) * 100, pr / (pr.sum() + 1e-6) * 100,
             "Percentage (%)", "Class Distribution Percentage"),
        )
        for ax, (a, b, ylabel, title) in zip(axes, panels):
            ax.bar(x - w / 2, a, w, label="Ground Truth", alpha=0.8,
                   edgecolor="black")
            ax.bar(x + w / 2, b, w, label="Prediction", alpha=0.8,
                   edgecolor="black")
            ax.set_xticks(x)
            ax.set_xticklabels(CLASS_NAMES, rotation=15, ha="right")
            ax.set_xlabel("Class", fontsize=12, fontweight="bold")
            ax.set_ylabel(ylabel, fontsize=12, fontweight="bold")
            ax.set_title(title, fontsize=14, fontweight="bold")
            ax.legend(fontsize=10, frameon=True, shadow=True)
            ax.grid(True, alpha=0.3, axis="y", linestyle="--")
            ax.spines["top"].set_visible(False)
            ax.spines["right"].set_visible(False)
        fig.tight_layout()
        self._save_figure(fig, f"{model_name}_class_distribution")

    def plot_feature_importance(self, masks_true, masks_pred, images,
                                model_name: str):
        """Spatial accuracy heatmap (visualization.py:1602-1627)."""
        acc = None
        for t, p in zip(masks_true, masks_pred):
            correct = (np.asarray(t) == np.asarray(p)).astype(np.float64)
            acc = correct if acc is None else acc + correct
        acc = acc / max(len(masks_true), 1)
        # the reference's two panels: accuracy (RdYlGn) + error (hot)
        fig, axes = plt.subplots(1, 2, figsize=(14, 6))
        im1 = axes[0].imshow(acc, cmap="RdYlGn", vmin=0, vmax=1)
        axes[0].set_title("Spatial Accuracy Heatmap", fontsize=14,
                          fontweight="bold")
        axes[0].axis("off")
        plt.colorbar(im1, ax=axes[0], label="Accuracy", fraction=0.046,
                     pad=0.04)
        im2 = axes[1].imshow(1 - acc, cmap="hot", vmin=0, vmax=1)
        axes[1].set_title("Spatial Error Heatmap", fontsize=14,
                          fontweight="bold")
        axes[1].axis("off")
        plt.colorbar(im2, ax=axes[1], label="Error Rate", fraction=0.046,
                     pad=0.04)
        fig.tight_layout()
        self._save_figure(fig, f"{model_name}_spatial_analysis")

    # ------------------------------------------------------ curve analyses
    def plot_roc_curves(self, probs_all, masks_true, model_name: str):
        """One-vs-rest ROC per class, one subplot each as in the reference
        (visualization.py:1096-1147), with the random-classifier diagonal."""
        fig, axes = plt.subplots(1, 3, figsize=(18, 6))
        for c in range(3):
            scores, labels = self._flatten_class(probs_all, masks_true, c)
            fpr, tpr = _roc(labels, scores)
            auc = float(np.trapezoid(tpr, fpr))
            ax = axes[c]
            ax.plot(fpr, tpr, linewidth=2.5,
                    label=f"ROC curve (AUC = {auc:.3f})")
            ax.plot([0, 1], [0, 1], "k--", linewidth=2,
                    label="Random Classifier")
            ax.set_xlabel("False Positive Rate", fontsize=12,
                          fontweight="bold")
            ax.set_ylabel("True Positive Rate", fontsize=12,
                          fontweight="bold")
            ax.set_title(f"{CLASS_NAMES[c]} ROC Curve", fontsize=14,
                         fontweight="bold")
            ax.legend(loc="lower right", frameon=True, shadow=True)
            ax.grid(True, alpha=0.3, linestyle="--")
            ax.spines["top"].set_visible(False)
            ax.spines["right"].set_visible(False)
        fig.tight_layout()
        self._save_figure(fig, f"{model_name}_roc_curves")

    def plot_pr_curves(self, probs_all, masks_true, model_name: str):
        """One-vs-rest precision/recall per class, one subplot each
        (visualization.py:1149-1199)."""
        fig, axes = plt.subplots(1, 3, figsize=(18, 6))
        for c in range(3):
            scores, labels = self._flatten_class(probs_all, masks_true, c)
            prec, rec = _pr(labels, scores)
            ap = abs(float(-np.trapezoid(prec, rec))) if len(rec) > 1 else 0.0
            ax = axes[c]
            ax.plot(rec, prec, linewidth=2.5,
                    label=f"PR curve (AP = {ap:.3f})")
            ax.set_xlabel("Recall", fontsize=12, fontweight="bold")
            ax.set_ylabel("Precision", fontsize=12, fontweight="bold")
            ax.set_title(f"{CLASS_NAMES[c]} PR Curve", fontsize=14,
                         fontweight="bold")
            ax.legend(loc="lower left", frameon=True, shadow=True)
            ax.grid(True, alpha=0.3, linestyle="--")
            ax.spines["top"].set_visible(False)
            ax.spines["right"].set_visible(False)
        fig.tight_layout()
        self._save_figure(fig, f"{model_name}_pr_curves")

    def plot_calibration_curve(self, probs_all, masks_true, model_name: str,
                               n_bins: int = 10):
        """The reference's calibration figure (visualization.py:1819-1900):
        per-class reliability curves + per-class confidence histograms in a
        1x3 layout whose third panel the reference leaves empty (kept for
        artifact parity)."""
        if probs_all is None or len(probs_all) == 0:
            return
        fig, axes = plt.subplots(1, 3, figsize=(18, 6))
        per_class_probs = {c: [] for c in range(3)}
        for c in range(3):
            labels = []
            for probs, t in zip(probs_all, masks_true):
                p = self._probs_hwc(probs)[..., c].ravel()
                per_class_probs[c].append(p)
                labels.append((np.asarray(t) == c).ravel())
            cp = np.concatenate(per_class_probs[c])
            cl = np.concatenate(labels)
            edges = np.linspace(0, 1, n_bins + 1)
            centers = (edges[:-1] + edges[1:]) / 2
            confs, accs = [], []
            for i in range(n_bins):
                sel = (cp >= edges[i]) & (cp < edges[i + 1])
                if sel.sum() > 0:
                    confs.append(cp[sel].mean()); accs.append(cl[sel].mean())
                else:
                    confs.append(centers[i]); accs.append(0)
            axes[0].plot(confs, accs, marker="o", linewidth=2.5,
                         markersize=8, label=CLASS_NAMES[c])
        axes[0].plot([0, 1], [0, 1], "k--", linewidth=2,
                     label="Perfect Calibration")
        axes[0].set_xlabel("Mean Predicted Probability", fontsize=12,
                           fontweight="bold")
        axes[0].set_ylabel("Fraction of Positives", fontsize=12,
                           fontweight="bold")
        axes[0].set_title("Calibration Curve", fontsize=14, fontweight="bold")
        axes[0].legend(fontsize=10, frameon=True, shadow=True)
        axes[0].grid(True, alpha=0.3, linestyle="--")
        for c in range(3):
            axes[1].hist(np.concatenate(per_class_probs[c]), bins=50,
                         alpha=0.6, label=CLASS_NAMES[c], edgecolor="black")
        axes[1].set_xlabel("Predicted Probability", fontsize=12,
                           fontweight="bold")
        axes[1].set_ylabel("Frequency", fontsize=12, fontweight="bold")
        axes[1].set_title("Confidence Distribution", fontsize=14,
                          fontweight="bold")
        axes[1].legend(fontsize=10, frameon=True, shadow=True)
        axes[1].grid(True, alpha=0.3, axis="y", linestyle="--")
        for ax in axes[:2]:
            ax.spines["top"].set_visible(False)
            ax.spines["right"].set_visible(False)
        fig.tight_layout()
        self._save_figure(fig, f"{model_name}_calibration")

    def plot_boundary_accuracy(self, masks_true, masks_pred, model_name: str):
        """The reference's boundary-vs-interior IoU boxplots
        (visualization.py:1687-1751): per (image, class) — all three
        classes — boundary = dilation minus erosion, interior = 2-iteration
        erosion, IoU of GT vs pred regions; red medians and mean labels."""
        from scipy.ndimage import binary_dilation, binary_erosion

        boundary_ious, interior_ious = [], []
        for t, p in zip(masks_true, masks_pred):
            t = np.asarray(t); p = np.asarray(p)
            for c in range(3):
                tm, pm = t == c, p == c
                if tm.sum() == 0:
                    continue
                tb = binary_dilation(tm) & ~binary_erosion(tm)
                pb = binary_dilation(pm) & ~binary_erosion(pm)
                ti = binary_erosion(tm, iterations=2)
                pi = binary_erosion(pm, iterations=2)
                if tb.sum() > 0:
                    boundary_ious.append((tb & pb).sum() / (tb | pb).sum())
                if ti.sum() > 0:
                    interior_ious.append((ti & pi).sum() / (ti | pi).sum())
        fig, ax = plt.subplots(figsize=(10, 6))
        data = [boundary_ious or [0.0], interior_ious or [0.0]]
        labels = ["Boundary", "Interior"]
        bp = ax.boxplot(data, tick_labels=labels, patch_artist=True,
                        widths=0.6)
        for patch in bp["boxes"]:
            patch.set_alpha(0.7)
            patch.set_edgecolor("black")
            patch.set_linewidth(2)
        for median in bp["medians"]:
            median.set_color("red")
            median.set_linewidth(2)
        for i, d in enumerate(data):
            ax.text(i + 1, np.mean(d), f"μ={np.mean(d):.3f}", ha="center",
                    va="bottom", fontweight="bold", fontsize=10,
                    bbox=dict(boxstyle="round", facecolor="white", alpha=0.8))
        ax.set_ylabel("IoU Score", fontsize=12, fontweight="bold")
        ax.set_title(f"{model_name} - Boundary vs Interior Accuracy",
                     fontsize=14, fontweight="bold")
        ax.grid(True, alpha=0.3, axis="y", linestyle="--")
        ax.spines["top"].set_visible(False)
        ax.spines["right"].set_visible(False)
        fig.tight_layout()
        self._save_figure(fig, f"{model_name}_boundary_accuracy")

    def plot_size_based_performance(self, masks_true, masks_pred,
                                    model_name: str):
        """IoU stratified by GT instance size (visualization.py:1753-1817)."""
        from scipy import ndimage

        # the reference's five size buckets, all three classes (background
        # included), default 4-connectivity components, and per-object
        # "IoU" = recall of the object's pixels (obj_pred.sum()/obj_size)
        size_ranges = [(0, 100), (100, 500), (500, 1000), (1000, 5000),
                       (5000, float("inf"))]
        range_labels = ["Tiny\n(0-100)", "Small\n(100-500)",
                        "Medium\n(500-1K)", "Large\n(1K-5K)", "Huge\n(5K+)"]
        ious_by_size = [[] for _ in size_ranges]
        for t, p in zip(masks_true, masks_pred):
            t = np.asarray(t); p = np.asarray(p)
            for c in range(3):
                lab, n = ndimage.label(t == c)
                pred_c = (p == c)
                for i in range(1, n + 1):
                    obj = lab == i
                    size = obj.sum()
                    iou = pred_c[obj].sum() / size if size > 0 else 0
                    for b, (lo, hi) in enumerate(size_ranges):
                        if lo <= size < hi:
                            ious_by_size[b].append(iou)
                            break
        fig, ax = plt.subplots(figsize=(12, 6))
        valid = [(d, l) for d, l in zip(ious_by_size, range_labels) if d]
        if valid:
            bp = ax.boxplot([d for d, _ in valid],
                            tick_labels=[l for _, l in valid],
                            patch_artist=True, widths=0.6)
            for patch in bp["boxes"]:
                patch.set_alpha(0.7)
                patch.set_edgecolor("black")
                patch.set_linewidth(2)
            for median in bp["medians"]:
                median.set_color("red")
                median.set_linewidth(2)
        ax.set_xlabel("Object Size (pixels)", fontsize=12, fontweight="bold")
        ax.set_ylabel("IoU Score", fontsize=12, fontweight="bold")
        ax.set_title(f"{model_name} - Performance by Object Size",
                     fontsize=14, fontweight="bold")
        ax.grid(True, alpha=0.3, axis="y", linestyle="--")
        ax.spines["top"].set_visible(False)
        ax.spines["right"].set_visible(False)
        fig.tight_layout()
        self._save_figure(fig, f"{model_name}_size_performance")

    # ----------------------------------------------------------- paper figs
    def create_paper_figures(self, images, masks_true, masks_pred,
                             model_name: str, filenames=None,
                             data_dir: str = "data"):
        """Four publication figures (visualization.py:1904-2186), matching
        the reference's panel layouts and annotations."""
        import warnings

        from matplotlib.patches import Patch

        # fig 1: 4 samples x 4 columns [from-disk original | preprocessed |
        # GT | pred], Chinese column titles, class legend at top (1910-2012)
        fig, axes = plt.subplots(4, 4, figsize=(20, 20))
        for i in range(min(4, len(images))):
            shown = _to_img(images[i])
            original = None
            if filenames and i < len(filenames):
                path = os.path.join(data_dir, str(filenames[i]))
                if os.path.exists(path):
                    try:
                        from PIL import Image

                        original = np.asarray(
                            Image.open(path).convert("RGB"),
                            dtype=np.float32) / 255.0
                    except Exception:
                        original = None
            if original is None:
                original = shown  # de-normalization approx (1932-1949)
            axes[i, 0].imshow(original)
            axes[i, 0].set_title("预处理前的原图", fontsize=12,
                                 fontweight="bold")
            axes[i, 1].imshow(shown)
            axes[i, 1].set_title("预处理后的图", fontsize=12,
                                 fontweight="bold")
            axes[i, 2].imshow(self._colorize_mask(masks_true[i]))
            axes[i, 2].set_title("真实标注", fontsize=12, fontweight="bold")
            axes[i, 3].imshow(self._colorize_mask(masks_pred[i]))
            axes[i, 3].set_title("预测标注", fontsize=12, fontweight="bold")
        for ax in axes.flat:
            ax.axis("off")
        legend = [Patch(facecolor=CLASS_COLORS[c], edgecolor="black",
                        label=CLASS_NAMES[c]) for c in range(3)]
        fig.legend(handles=legend, loc="upper center", ncol=3, fontsize=12,
                   frameon=True, shadow=True, bbox_to_anchor=(0.5, 0.98))
        with warnings.catch_warnings():
            if _cjk is None:  # fig1's Chinese titles; see module header
                warnings.filterwarnings(
                    "ignore", message=r"Glyph \d+ .* missing from font")
            fig.tight_layout(rect=[0, 0, 1, 0.97])
            self._save_figure(fig, f"{model_name}_paper_fig1_comparison")

        # fig 2: 2x2 prediction overlays, 0.5 blend over every class incl.
        # background (2014-2060)
        fig, axes = plt.subplots(2, 2, figsize=(14, 14))
        axes = axes.flatten()
        for i in range(min(4, len(images))):
            img = _to_img(images[i])
            overlay = np.clip(
                img * 0.5 + self._colorize_mask(masks_pred[i]) * 0.5, 0, 1)
            axes[i].imshow(overlay)
            axes[i].set_title(f"Sample {i + 1} - Prediction Overlay",
                              fontsize=12, fontweight="bold")
        for ax in axes:
            ax.axis("off")
        fig.tight_layout()
        self._save_figure(fig, f"{model_name}_paper_fig2_overlay")

        # fig 3: 2x2 error maps (any-mismatch, Reds over the image) with a
        # shared horizontal colorbar (2062-2113)
        fig, axes = plt.subplots(2, 2, figsize=(14, 14))
        axes = axes.flatten()
        im = None
        for i in range(min(4, len(images))):
            t = np.asarray(masks_true[i]); p = np.asarray(masks_pred[i])
            axes[i].imshow(_to_img(images[i]), alpha=0.7)
            im = axes[i].imshow((t != p).astype(float), cmap="Reds",
                                alpha=0.5, vmin=0, vmax=1)
            axes[i].set_title(f"Sample {i + 1} - Error Map", fontsize=12,
                              fontweight="bold")
        for ax in axes:
            ax.axis("off")
        if im is not None:
            cbar = fig.colorbar(im, ax=axes, orientation="horizontal",
                                fraction=0.05, pad=0.05, aspect=30)
            cbar.set_label("Error (Red = Incorrect)", fontsize=12,
                           fontweight="bold")
        self._save_figure(fig, f"{model_name}_paper_fig3_errors")

        # fig 4: single-sample gridspec panel — original (2-row span), GT,
        # pred, error map, per-class masks, stats box (2115-2186)
        t = np.asarray(masks_true[0]); p = np.asarray(masks_pred[0])
        fig = plt.figure(figsize=(18, 6))
        gs = fig.add_gridspec(2, 4, hspace=0.3, wspace=0.3)
        ax1 = fig.add_subplot(gs[:, 0])
        ax1.imshow(_to_img(images[0]))
        ax1.set_title("Original Image", fontsize=14, fontweight="bold")
        ax2 = fig.add_subplot(gs[0, 1])
        ax2.imshow(self._colorize_mask(t))
        ax2.set_title("Ground Truth", fontsize=14, fontweight="bold")
        ax3 = fig.add_subplot(gs[0, 2])
        ax3.imshow(self._colorize_mask(p))
        ax3.set_title("Prediction", fontsize=14, fontweight="bold")
        ax4 = fig.add_subplot(gs[0, 3])
        ax4.imshow((t != p).astype(float), cmap="Reds", vmin=0, vmax=1)
        ax4.set_title("Error Map", fontsize=14, fontweight="bold")
        ax5 = fig.add_subplot(gs[1, 1])
        ax5.imshow(p == 1, cmap="Greens", vmin=0, vmax=1)
        ax5.set_title(CLASS_NAMES[1], fontsize=12, fontweight="bold")
        ax6 = fig.add_subplot(gs[1, 2])
        ax6.imshow(p == 2, cmap="Reds", vmin=0, vmax=1)
        ax6.set_title(CLASS_NAMES[2], fontsize=12, fontweight="bold")
        for ax in (ax1, ax2, ax3, ax4, ax5, ax6):
            ax.axis("off")
        ax7 = fig.add_subplot(gs[1, 3])
        ax7.axis("off")
        stats = (
            "Sample Metrics:\n\n"
            f"Accuracy: {(t == p).mean():.3f}\n\n"
            f"{CLASS_NAMES[0]} IoU: {calculate_iou(p == 0, t == 0):.3f}\n"
            f"{CLASS_NAMES[1]} IoU: {calculate_iou(p == 1, t == 1):.3f}\n"
            f"{CLASS_NAMES[2]} IoU: {calculate_iou(p == 2, t == 2):.3f}\n\n"
            f"Background: {(p == 0).sum()} px\n"
            f"Live Cells: {(p == 1).sum()} px\n"
            f"Dead Cells: {(p == 2).sum()} px\n"
        )
        ax7.text(0.1, 0.5, stats, fontsize=11, verticalalignment="center",
                 bbox=dict(boxstyle="round", facecolor="wheat", alpha=0.5))
        fig.tight_layout()
        self._save_figure(fig, f"{model_name}_paper_fig4_detailed")

    def plot_cell_count_comparison(self, comparison_data: List[Dict],
                                   model_name: str):
        """Per-image GT/pred cell counts + viability, with CSV dump
        (visualization.py:2215-2429)."""
        if not comparison_data:
            return
        x = np.arange(len(comparison_data))
        gl = np.array([d["gt_live_count"] for d in comparison_data], float)
        pl = np.array([d["pred_live_count"] for d in comparison_data], float)
        gd = np.array([d["gt_dead_count"] for d in comparison_data], float)
        pd_ = np.array([d["pred_dead_count"] for d in comparison_data], float)
        gv = np.array([d["gt_viability"] for d in comparison_data], float)
        pv = np.array([d["pred_viability"] for d in comparison_data], float)

        fig = plt.figure(figsize=(20, 16))
        gs = fig.add_gridspec(3, 3, hspace=0.3, wspace=0.3)
        w = 0.35
        # row 0: per-image bars (live / dead / viability), 实际 vs 预测
        bars = ((gl, pl, "活细胞数量对比", "数量"),
                (gd, pd_, "死细胞数量对比", "数量"),
                (gv, pv, "细胞活力对比", "活力 (%)"))
        for col, (a, b, title, ylabel) in enumerate(bars):
            ax = fig.add_subplot(gs[0, col])
            ax.bar(x - w / 2, a, w, label="实际", alpha=0.8)
            ax.bar(x + w / 2, b, w, label="预测", alpha=0.8)
            ax.set_title(title, fontsize=14, fontweight="bold")
            ax.set_ylabel(ylabel, fontsize=12)
            ax.set_xlabel("图像编号", fontsize=12)
            ax.legend(); ax.grid(True, alpha=0.3, axis="y", linestyle="--")
        # row 1: pred-vs-GT scatters with the ideal line and Pearson R
        scatters = ((gl, pl, "活细胞数量：预测 vs 实际", None),
                    (gd, pd_, "死细胞数量：预测 vs 实际", None),
                    (gv, pv, "细胞活力：预测 vs 实际", 100.0))
        for col, (a, b, title, fixed_max) in enumerate(scatters):
            ax = fig.add_subplot(gs[1, col])
            ax.scatter(a, b, s=100, alpha=0.7, edgecolors="black",
                       linewidth=1.5)
            mx = fixed_max if fixed_max is not None else max(
                a.max() if a.size else 1, b.max() if b.size else 1)
            ax.plot([0, mx], [0, mx], "r--", linewidth=2, alpha=0.5,
                    label="理想线")
            if a.size > 1 and a.std() > 0 and b.std() > 0:
                r = float(np.corrcoef(a, b)[0, 1])
                ax.text(0.05, 0.95, f"R = {r:.3f}", transform=ax.transAxes,
                        fontsize=11, fontweight="bold", va="top",
                        bbox=dict(boxstyle="round", facecolor="white",
                                  alpha=0.8))
            ax.set_title(title, fontsize=14, fontweight="bold")
            ax.set_xlabel("实际", fontsize=12); ax.set_ylabel("预测", fontsize=12)
            ax.legend(); ax.grid(True, alpha=0.3, linestyle="--")
        # row 2: the color-coded detail table (visualization.py:2350-2420)
        ax7 = fig.add_subplot(gs[2, :])
        ax7.axis("tight"); ax7.axis("off")
        rows = []
        for i, d in enumerate(comparison_data):
            name = d["filename"]
            rows.append([
                f"#{i + 1}",
                name[:20] + "..." if len(name) > 20 else name,
                f"{d['gt_live_count']}", f"{d['pred_live_count']}",
                f"{d['gt_dead_count']}", f"{d['pred_dead_count']}",
                f"{d['gt_viability']:.2f}%", f"{d['pred_viability']:.2f}%",
                f"{d['live_error']:+d}", f"{d['dead_error']:+d}",
                f"{d['viability_error']:+.2f}%",
            ])
        columns = ["编号", "图像文件名", "实际活细胞", "预测活细胞",
                   "实际死细胞", "预测死细胞", "实际活力", "预测活力",
                   "活细胞误差", "死细胞误差", "活力误差"]
        table = ax7.table(cellText=rows, colLabels=columns, cellLoc="center",
                          loc="center", bbox=[0, 0, 1, 1])
        table.auto_set_font_size(False)
        table.set_fontsize(9)
        table.scale(1, 1.5)
        for j in range(len(columns)):
            table[(0, j)].set_facecolor("#4A90E2")
            table[(0, j)].set_text_props(weight="bold", color="white")

        def _err_color(err, small, mid):
            err = abs(err)
            return ("#90EE90" if err <= small
                    else "#FFE4B5" if err <= mid else "#FFB6C1")

        for i in range(1, len(rows) + 1):
            d = comparison_data[i - 1]
            for j in range(len(columns)):
                table[(i, j)].set_facecolor(
                    "#F0F0F0" if i % 2 == 0 else "white")
            table[(i, 8)].set_facecolor(_err_color(d["live_error"], 2, 5))
            table[(i, 9)].set_facecolor(_err_color(d["dead_error"], 2, 5))
            table[(i, 10)].set_facecolor(
                _err_color(d["viability_error"], 5, 10))
        ax7.set_title(f"{model_name} - 每张图像的细胞数量和细胞活力详细对比",
                      fontsize=16, fontweight="bold", pad=20)
        fig.suptitle(f"{model_name} - 实际 vs 预测对比分析", fontsize=18,
                     fontweight="bold", y=0.995)
        self._save_figure(fig, f"{model_name}_cell_count_comparison")

        # CSV with utf-8-sig, the reference's Excel-compatible encoding
        csv_path = os.path.join(
            self.save_dir, f"{model_name}_cell_count_comparison.csv"
        )
        with open(csv_path, "w", newline="", encoding="utf-8-sig") as f:
            w_ = csv.DictWriter(f, fieldnames=list(comparison_data[0]))
            w_.writeheader()
            w_.writerows(comparison_data)

    # --------------------------------------------------- cross-model suite
    def plot_model_comparison(self, results: Dict[str, Dict]):
        """The reference's basic comparison: 1x3 labeled bars for mIoU /
        mDice / accuracy (visualization.py:496-531)."""
        models = list(results)
        fig, axes = plt.subplots(1, 3, figsize=(18, 6))
        panels = (
            ("sem_mean_iou", "IoU"),
            ("sem_mean_dice", "Dice"),
            ("viability_accuracy", "Accuracy"),
        )
        for ax, (key, title) in zip(axes.ravel(), panels):
            vals = [results[m].get(key, 0.0) for m in models]
            ax.bar(models, vals, alpha=0.8)
            for i, v in enumerate(vals):
                ax.text(i, v + 0.01, f"{v:.4f}", ha="center", va="bottom",
                        fontsize=9, fontweight="bold")
            ax.set_ylabel(title, fontsize=12, fontweight="bold")
            ax.set_title(f"{title} Comparison", fontsize=14,
                         fontweight="bold")
            ax.set_xticks(np.arange(len(models)))
            ax.set_xticklabels(models, rotation=45, ha="right")
            ax.grid(True, alpha=0.3, axis="y", linestyle="--")
            ax.spines["top"].set_visible(False)
            ax.spines["right"].set_visible(False)
        fig.tight_layout()
        self._save_figure(fig, "model_comparison")

    def plot_comprehensive_comparison(self, results: Dict[str, Dict]):
        """12-figure comparison suite (visualization.py:534-1025):
        overall bars, per-class IoU/Dice, radar, heatmap, boxplot, stacked,
        scatter, ranking, composite score, balance, table."""
        models = list(results)
        if not models:
            return

        def get(m, k, d=0.0):
            return float(results[m].get(k, d))

        # 1. overall metrics: the reference's 1x3 labeled-bar panel
        # (Mean IoU / Mean Dice / Accuracy, visualization.py:540-575)
        x = np.arange(len(models))
        fig, axes = plt.subplots(1, 3, figsize=(18, 6))
        for ax, (key, label) in zip(axes, (
            ("sem_mean_iou", "Mean IoU"),
            ("sem_mean_dice", "Mean Dice"),
            ("viability_accuracy", "Accuracy"),
        )):
            vals = [get(m, key) for m in models]
            top = max(vals) if max(vals, default=0) > 0 else 1.0
            bars = ax.bar(models, vals, alpha=0.8, edgecolor="black",
                          linewidth=1.5)
            for bar, v in zip(bars, vals):
                ax.text(bar.get_x() + bar.get_width() / 2, v + top * 0.02,
                        f"{v:.4f}", ha="center", va="bottom", fontsize=9,
                        fontweight="bold")
            ax.set_ylabel(label, fontsize=12, fontweight="bold")
            ax.set_title(f"{label} Comparison", fontsize=14,
                         fontweight="bold")
            ax.set_xticks(x)
            ax.set_xticklabels(models, rotation=45, ha="right")
            ax.set_ylim([0, top * 1.15])
            ax.grid(True, alpha=0.3, axis="y", linestyle="--")
            ax.spines["top"].set_visible(False)
            ax.spines["right"].set_visible(False)
        fig.tight_layout()
        self._save_figure(fig, "comparison_overall_metrics")

        # 2-3. per-class IoU / Dice: the reference's one-subplot-per-class
        # labeled bars (visualization.py:570-640)
        for metric, fname in (("iou", "comparison_class_iou"),
                              ("dice", "comparison_class_dice")):
            fig, axes = plt.subplots(1, 3, figsize=(18, 6))
            for ci, (ax, cname) in enumerate(zip(axes, CLASS_NAMES)):
                vals = [get(m, f"sem_{cname}_{metric}") for m in models]
                top = max(vals) if max(vals, default=0) > 0 else 1.0
                bars = ax.bar(models, vals, alpha=0.8, edgecolor="black",
                              linewidth=1.5)
                for bar, v in zip(bars, vals):
                    ax.text(bar.get_x() + bar.get_width() / 2,
                            v + top * 0.02, f"{v:.4f}", ha="center",
                            va="bottom", fontsize=9, fontweight="bold")
                ax.set_ylabel(f"{metric.capitalize()} Score", fontsize=12,
                              fontweight="bold")
                ax.set_title(f"{cname} {metric.capitalize()} Comparison",
                             fontsize=14, fontweight="bold")
                ax.set_xticks(x)
                ax.set_xticklabels(models, rotation=45, ha="right")
                ax.set_ylim([0, top * 1.15])
                ax.grid(True, alpha=0.3, axis="y", linestyle="--")
                ax.spines["top"].set_visible(False)
                ax.spines["right"].set_visible(False)
            fig.tight_layout()
            self._save_figure(fig, fname)

        # 4. radar: the reference's five axes — live/dead IoU, live/dead
        # Dice, accuracy (visualization.py:644-682)
        radar = (("Live Cells IoU", "sem_live_iou"),
                 ("Dead Cells IoU", "sem_dead_iou"),
                 ("Live Cells Dice", "sem_live_dice"),
                 ("Dead Cells Dice", "sem_dead_dice"),
                 ("Accuracy", "viability_accuracy"))
        angles = np.linspace(0, 2 * np.pi, len(radar), endpoint=False)
        closed = np.append(angles, angles[0])
        fig, ax = plt.subplots(figsize=(10, 10), subplot_kw={"polar": True})
        for m in models:
            vals = [get(m, k) for _, k in radar]
            ax.plot(closed, vals + [vals[0]], "o-", linewidth=2, label=m,
                    markersize=8)
            ax.fill(closed, vals + [vals[0]], alpha=0.15)
        ax.set_xticks(angles)
        ax.set_xticklabels([l for l, _ in radar], fontsize=10)
        ax.set_ylim([0, 1])
        ax.set_yticks([0.2, 0.4, 0.6, 0.8, 1.0])
        ax.grid(True)
        ax.legend(loc="upper right", bbox_to_anchor=(1.3, 1.1), fontsize=10)
        ax.set_title("Model Performance Radar Chart", fontsize=14,
                     fontweight="bold", pad=20)
        self._save_figure(fig, "comparison_radar")

        # 5. heatmap: the reference's seven columns on YlOrRd, [0,1]
        # (visualization.py:684-730)
        hm = (("Live IoU", "sem_live_iou"), ("Dead IoU", "sem_dead_iou"),
              ("Mean IoU", "sem_mean_iou"), ("Live Dice", "sem_live_dice"),
              ("Dead Dice", "sem_dead_dice"), ("Mean Dice", "sem_mean_dice"),
              ("Accuracy", "viability_accuracy"))
        hm_keys = [k for _, k in hm]
        mat = np.array([[get(m, k) for k in hm_keys] for m in models])
        fig, ax = plt.subplots(figsize=(12, max(4, 0.8 * len(models) + 2)))
        im = ax.imshow(mat, cmap="YlOrRd", aspect="auto", vmin=0, vmax=1)
        ax.set_xticks(range(len(hm)))
        ax.set_xticklabels([l for l, _ in hm], rotation=45, ha="right")
        ax.set_yticks(range(len(models))); ax.set_yticklabels(models)
        for i in range(len(models)):
            for j in range(len(hm)):
                ax.text(j, i, f"{mat[i, j]:.3f}", ha="center", va="center",
                        fontsize=9,
                        color="white" if mat[i, j] > 0.5 else "black")
        ax.set_title("Model Performance Heatmap", fontsize=14,
                     fontweight="bold")
        fig.colorbar(im, label="Score")
        fig.tight_layout()
        self._save_figure(fig, "comparison_heatmap")

        # 6. per-class [IoU, Dice] across-model distribution boxplots
        # (visualization.py:731-790)
        fig, axes = plt.subplots(1, 3, figsize=(21, 6))
        for ci, (ax, cname) in enumerate(zip(axes, CLASS_NAMES)):
            iou_data = [get(m, f"sem_{cname}_iou") for m in models]
            dice_data = [get(m, f"sem_{cname}_dice") for m in models]
            bp = ax.boxplot([iou_data, dice_data],
                            tick_labels=["IoU", "Dice"], patch_artist=True,
                            widths=0.6)
            for patch in bp["boxes"]:
                patch.set_alpha(0.7)
                patch.set_edgecolor("black")
            ax.set_ylabel("Score", fontsize=12, fontweight="bold")
            ax.set_title(f"{cname} Metrics Distribution", fontsize=14,
                         fontweight="bold")
            ax.grid(True, alpha=0.3, axis="y", linestyle="--")
            ax.spines["top"].set_visible(False)
            ax.spines["right"].set_visible(False)
        fig.tight_layout()
        self._save_figure(fig, "comparison_boxplot")

        # 7. live-vs-dead side-by-side bars per metric with value labels
        # (the reference's "stacked" slot, visualization.py:792-838)
        fig, axes = plt.subplots(1, 2, figsize=(14, 6))
        w = 0.35
        for mi, (ax, metric) in enumerate(zip(axes, ("iou", "dice"))):
            live = [get(m, f"sem_live_{metric}") for m in models]
            dead = [get(m, f"sem_dead_{metric}") for m in models]
            bars1 = ax.bar(x - w / 2, live, w, label="Live Cells",
                           alpha=0.8, edgecolor="black", linewidth=1.5)
            bars2 = ax.bar(x + w / 2, dead, w, label="Dead Cells",
                           alpha=0.8, edgecolor="black", linewidth=1.5)
            for bars in (bars1, bars2):
                for bar in bars:
                    h = bar.get_height()
                    if h > 0.01:
                        ax.text(bar.get_x() + bar.get_width() / 2, h + 0.01,
                                f"{h:.3f}", ha="center", va="bottom",
                                fontsize=8, fontweight="bold")
            label = metric.capitalize() if metric == "dice" else "IoU"
            ax.set_ylabel(f"{label} Score", fontsize=12, fontweight="bold")
            ax.set_title(f"{label} - Live vs Dead Cells Comparison",
                         fontsize=14, fontweight="bold")
            ax.set_xticks(x)
            ax.set_xticklabels(models, rotation=45, ha="right")
            ax.legend(fontsize=10, frameon=True, shadow=True,
                      loc="upper right")
            ax.set_ylim([0, max(max(live, default=0), max(dead, default=0),
                                0.01) * 1.15])
            ax.grid(True, alpha=0.3, axis="y", linestyle="--")
            ax.spines["top"].set_visible(False)
            ax.spines["right"].set_visible(False)
        fig.tight_layout()
        self._save_figure(fig, "comparison_stacked")

        # 8. scatter: Mean IoU vs Mean Dice with the diagonal, [0,1] axes
        # (visualization.py:840-869)
        fig, ax = plt.subplots(figsize=(10, 8))
        for m in models:
            miou, mdice = get(m, "sem_mean_iou"), get(m, "sem_mean_dice")
            ax.scatter(miou, mdice, s=200, alpha=0.7, edgecolors="black",
                       linewidth=1.5)
            ax.annotate(m, (miou, mdice), xytext=(5, 5),
                        textcoords="offset points", fontsize=10,
                        fontweight="bold")
        ax.plot([0, 1], [0, 1], "k--", alpha=0.3, linewidth=1)
        ax.set_xlim([0, 1]); ax.set_ylim([0, 1])
        ax.set_xlabel("Mean IoU", fontsize=12, fontweight="bold")
        ax.set_ylabel("Mean Dice", fontsize=12, fontweight="bold")
        ax.set_title("Model Performance: IoU vs Dice", fontsize=14,
                     fontweight="bold")
        ax.grid(True, alpha=0.3, linestyle="--")
        ax.spines["top"].set_visible(False)
        ax.spines["right"].set_visible(False)
        fig.tight_layout()
        self._save_figure(fig, "comparison_scatter")

        # 9. per-metric sorted rankings: the reference's 2x2 barh panel with
        # value labels (visualization.py:872-906)
        fig, axes = plt.subplots(2, 2, figsize=(14, 12))
        axes = axes.flatten()
        metrics_to_rank = (
            ("Mean IoU", "sem_mean_iou"),
            ("Mean Dice", "sem_mean_dice"),
            ("Accuracy", "viability_accuracy"),
            ("Dead Cells IoU", "sem_dead_iou"),
        )
        for idx, (label, key) in enumerate(metrics_to_rank):
            scores = sorted(((m, get(m, key)) for m in models),
                            key=lambda t: t[1], reverse=True)
            names = [s[0] for s in scores]
            vals = [s[1] for s in scores]
            top = max(vals) if max(vals, default=0) > 0 else 1.0
            bars = axes[idx].barh(names, vals, alpha=0.8, edgecolor="black",
                                  linewidth=1.5)
            for bar, v in zip(bars, vals):
                axes[idx].text(v + top * 0.01,
                               bar.get_y() + bar.get_height() / 2,
                               f"{v:.4f}", ha="left", va="center",
                               fontsize=9, fontweight="bold")
            axes[idx].set_xlabel(label, fontsize=12, fontweight="bold")
            axes[idx].set_title(f"{label} Ranking", fontsize=14,
                                fontweight="bold")
            axes[idx].set_xlim([0, top * 1.1])
            axes[idx].grid(True, alpha=0.3, axis="x", linestyle="--")
            axes[idx].spines["top"].set_visible(False)
            axes[idx].spines["right"].set_visible(False)
        fig.tight_layout()
        self._save_figure(fig, "comparison_ranking")

        # 10. composite score with the reference's weights: mIoU*0.4 +
        # mDice*0.4 + accuracy*0.2 (visualization.py:908-937)
        comps = [0.4 * get(m, "sem_mean_iou") + 0.4 * get(m, "sem_mean_dice")
                 + 0.2 * get(m, "viability_accuracy") for m in models]
        top = max(comps) if max(comps, default=0) > 0 else 1.0
        fig, ax = plt.subplots(figsize=(12, 6))
        bars = ax.bar(models, comps, alpha=0.8, edgecolor="black",
                      linewidth=1.5)
        for bar, v in zip(bars, comps):
            ax.text(bar.get_x() + bar.get_width() / 2, v + top * 0.02,
                    f"{v:.4f}", ha="center", va="bottom", fontsize=10,
                    fontweight="bold")
        ax.set_ylabel("Composite Score", fontsize=12, fontweight="bold")
        ax.set_title("Model Composite Performance Score\n"
                     "(Mean IoU×0.4 + Mean Dice×0.4 + Accuracy×0.2)",
                     fontsize=14, fontweight="bold")
        ax.set_xticks(x)
        ax.set_xticklabels(models, rotation=45, ha="right")
        ax.set_ylim([0, top * 1.15])
        ax.grid(True, alpha=0.3, axis="y", linestyle="--")
        ax.spines["top"].set_visible(False)
        ax.spines["right"].set_visible(False)
        fig.tight_layout()
        self._save_figure(fig, "comparison_composite")

        # 11. class balance: the |live IoU - dead IoU| performance gap with
        # value labels, lower is better (visualization.py:940-969)
        fig, ax = plt.subplots(figsize=(12, 6))
        gaps = [abs(get(m, "sem_live_iou") - get(m, "sem_dead_iou"))
                for m in models]
        bars = ax.bar(models, gaps, alpha=0.8, edgecolor="black",
                      linewidth=1.5)
        top = max(gaps) if max(gaps, default=0) > 0 else 1.0
        for bar, score in zip(bars, gaps):
            ax.text(bar.get_x() + bar.get_width() / 2, score + top * 0.02,
                    f"{score:.4f}", ha="center", va="bottom", fontsize=9,
                    fontweight="bold")
        ax.set_ylabel("Performance Gap (|Live IoU - Dead IoU|)", fontsize=12,
                      fontweight="bold")
        ax.set_title("Class Balance Analysis\n(Lower is Better)",
                     fontsize=14, fontweight="bold")
        ax.set_xticks(x)
        ax.set_xticklabels(models, rotation=45, ha="right")
        ax.grid(True, alpha=0.3, axis="y", linestyle="--")
        ax.spines["top"].set_visible(False)
        ax.spines["right"].set_visible(False)
        fig.tight_layout()
        self._save_figure(fig, "comparison_balance")

        # 12. the reference's 8-column styled table (visualization.py:
        # 971-1022): blue header, zebra rows
        fig, ax = plt.subplots(figsize=(14, 8))
        ax.axis("tight"); ax.axis("off")
        columns = ["Model", "Accuracy", "Live IoU", "Dead IoU", "Mean IoU",
                   "Live Dice", "Dead Dice", "Mean Dice"]
        cells = [[
            m,
            f"{get(m, 'viability_accuracy'):.4f}",
            f"{get(m, 'sem_live_iou'):.4f}",
            f"{get(m, 'sem_dead_iou'):.4f}",
            f"{get(m, 'sem_mean_iou'):.4f}",
            f"{get(m, 'sem_live_dice'):.4f}",
            f"{get(m, 'sem_dead_dice'):.4f}",
            f"{get(m, 'sem_mean_dice'):.4f}",
        ] for m in models]
        table = ax.table(cellText=cells, colLabels=columns, cellLoc="center",
                         loc="center", bbox=[0, 0, 1, 1])
        table.auto_set_font_size(False)
        table.set_fontsize(10)
        table.scale(1, 2)
        for j in range(len(columns)):
            table[(0, j)].set_facecolor("#4A90E2")
            table[(0, j)].set_text_props(weight="bold", color="white")
        for i in range(1, len(cells) + 1):
            for j in range(len(columns)):
                table[(i, j)].set_facecolor(
                    "#F0F0F0" if i % 2 == 0 else "white")
        ax.set_title("Detailed Model Performance Table", fontsize=16,
                     fontweight="bold", pad=20)
        self._save_figure(fig, "comparison_table")

    def load_evaluation_results(self):
        """results/evaluation_results.csv -> list of dicts
        (visualization.py:1027-1040; pandas-free)."""
        path = os.path.join(self.save_dir, "evaluation_results.csv")
        if not os.path.exists(path):
            return []
        with open(path, newline="", encoding="utf-8-sig") as f:
            return list(csv.DictReader(f))

    # CSV column -> metric key (the CLI's Chinese schema, main.py:256-276)
    _CSV_KEYS = {
        "语义分割 mIoU": "sem_mean_iou",
        "语义分割 mDice": "sem_mean_dice",
        "语义分割-背景 IoU": "sem_background_iou",
        "语义分割-背景 Dice": "sem_background_dice",
        "语义分割-活细胞 IoU": "sem_live_iou",
        "语义分割-死细胞 IoU": "sem_dead_iou",
        "语义分割-活细胞 Dice": "sem_live_dice",
        "语义分割-死细胞 Dice": "sem_dead_dice",
        "实例分割-活细胞 IoU": "live_iou",
        "实例分割-死细胞 IoU": "dead_iou",
        "活细胞检测准确率 (Precision)": "live_precision",
        "死细胞检测准确率 (Precision)": "dead_precision",
        "活细胞召回率 (Recall)": "live_recall",
        "死细胞召回率 (Recall)": "dead_recall",
        "细胞活力准确率": "viability_accuracy",
        "bbox mAP": "bbox_mAP",
        "segm mAP": "segm_mAP",
    }

    def plot_comprehensive_comparison_from_csv(self):
        """Rebuild the comparison suite from the CLI's saved artifacts
        (visualization.py:1042-1093): prefers evaluation_results.json,
        falls back to the Chinese-header CSV."""
        json_path = os.path.join(self.save_dir, "evaluation_results.json")
        if os.path.exists(json_path):
            with open(json_path, encoding="utf-8") as f:
                results = json.load(f)
            self.plot_comprehensive_comparison(results)
            return True
        rows = self.load_evaluation_results()
        if rows:
            results = {}
            for row in rows:
                name = row.get("模型") or row.get("model") or "?"
                results[name] = {
                    key: float(row[col])
                    for col, key in self._CSV_KEYS.items()
                    if row.get(col) not in (None, "")
                }
            self.plot_comprehensive_comparison(results)
            return True
        return False

    # ------------------------------------------------------------- helpers
    @staticmethod
    def _probs_hwc(probs) -> np.ndarray:
        p = np.asarray(probs)
        if p.ndim == 3 and p.shape[0] == 3 and p.shape[0] < p.shape[-1]:
            p = np.transpose(p, (1, 2, 0))
        return p

    def _flatten_class(self, probs_all, masks_true, c, max_px: int = 200_000):
        scores, labels = [], []
        for probs, t in zip(probs_all, masks_true):
            p = self._probs_hwc(probs)
            t = np.asarray(t).ravel()
            valid = t != 255  # ignore-index filter (visualization.py:1110)
            scores.append(p[..., c].ravel()[valid])
            labels.append(t[valid] == c)
        scores = np.concatenate(scores); labels = np.concatenate(labels)
        if scores.size > max_px:  # subsample for plot speed
            idx = np.random.default_rng(0).choice(scores.size, max_px,
                                                  replace=False)
            scores, labels = scores[idx], labels[idx]
        return scores, labels


def _roc(labels: np.ndarray, scores: np.ndarray):
    order = np.argsort(-scores)
    labels = labels[order]
    tps = np.cumsum(labels)
    fps = np.cumsum(~labels)
    P = max(labels.sum(), 1)
    N = max((~labels).sum(), 1)
    tpr = np.concatenate([[0], tps / P, [1]])
    fpr = np.concatenate([[0], fps / N, [1]])
    return fpr, tpr


def _pr(labels: np.ndarray, scores: np.ndarray):
    order = np.argsort(-scores)
    labels = labels[order]
    tps = np.cumsum(labels)
    fps = np.cumsum(~labels)
    P = max(labels.sum(), 1)
    prec = tps / np.maximum(tps + fps, 1)
    rec = tps / P
    return np.concatenate([[1], prec]), np.concatenate([[0], rec])
