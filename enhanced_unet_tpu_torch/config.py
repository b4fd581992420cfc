"""Configuration system (a copy of the JAX package's `config.py`, kept
here so the PyTorch package imports nothing of the JAX package).

The reference hard-codes per-model policy tables inside code (loss weights
train_eval.py:82-107, base LR train_eval.py:112-119, batch size & epoch
scaling train_eval.py:1058-1069, early-stop patience train_eval.py:1097,
TTA gating train_eval.py:363, warmup train_eval.py:122, cosine-restart
scheduler train_eval.py:124-129, split ratios dataset.py:42-44, max_size
train_eval.py:1054).  Here those same numbers live in one typed config with
per-model presets, so they are inspectable, serializable and overridable.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

MODEL_NAMES = ("segnet", "unet", "enhanced_unet", "fcn", "pspnet", "linknet")

NUM_CLASSES = 3  # 0: background, 1: live, 2: dead


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Combined Focal + Dice + Tversky loss bundle.

    Values mirror reference train_eval.py:72-107 exactly.
    """

    # CE class weights for the focal term [background, live, dead]
    # (train_eval.py:74)
    ce_class_weights: Tuple[float, float, float] = (1.0, 20.0, 10.0)
    # Focal alpha per class (train_eval.py:75)
    focal_alpha: Tuple[float, float, float] = (1.0, 8.0, 5.0)
    focal_gamma: float = 5.0  # train_eval.py:79
    # Dice per-class weights (train_eval.py:140)
    dice_class_weights: Tuple[float, float, float] = (1.0, 15.0, 8.0)
    # Tversky per-class weights and alpha (train_eval.py:164, 159)
    tversky_class_weights: Tuple[float, float, float] = (1.0, 12.0, 6.0)
    tversky_alpha: float = 0.7
    # Per-model combination weights (train_eval.py:82-107)
    dice_weight: float = 1.5
    focal_weight: float = 1.5
    tversky_weight: float = 0.5
    # Deep supervision over the enhanced_unet aux branches
    # (train_eval.py:86-87)
    aux_branch_weights: Tuple[Tuple[str, float], ...] = ()
    consistency_weight: float = 0.0
    eps: float = 1e-6


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """AdamW + linear warmup + cosine annealing with warm restarts.

    Mirrors reference train_eval.py:109-132 and the epoch-granular stepping
    at train_eval.py:1100-1111.
    """

    base_lr: float = 2e-3
    weight_decay: float = 1e-4  # train_eval.py:120
    betas: Tuple[float, float] = (0.9, 0.999)
    grad_clip_norm: float = 1.0  # train_eval.py:341
    warmup_start_factor: float = 0.001  # train_eval.py:131
    # warmup_epochs = max(1, min(5, total_epochs // 6))  (train_eval.py:122)
    # cosine restarts: T_0 = max(10, total_epochs // 3), T_mult=2,
    # eta_min=1e-7 (train_eval.py:124-129)
    t_mult: int = 2
    eta_min: float = 1e-7
    # dtype of AdamW's first moment (optax mu_dtype).  "bfloat16" halves the
    # mu buffer's HBM footprint (params stay fp32, nu stays fp32; optax casts
    # mu back to fp32 for the update) — an HBM lever for larger train
    # batches.  Default fp32 = exact reference parity.
    mu_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "unet"
    num_classes: int = NUM_CLASSES
    # Compute dtype for conv/matmul (params are always fp32).  bf16 is the
    # serving default; fp32 is used for tests / strict parity.
    compute_dtype: str = "bfloat16"
    # Space-to-depth packed UNet++ decoder in the JAX package (a TPU layout
    # rewrite of the same math on the same parameters).  Accepted here for
    # config compatibility; the PyTorch models compute the plain math.
    packed_decoder: bool = True
    # Serving preset: "exact" reproduces the reference placement
    # bit-for-bit-within-tolerance; "optimized" stacks the
    # receipts-approved NON-logit-exact serving options
    # (SERVING_OPTIMIZED_KWARGS below) for throughput-first deployments.
    # Parameter trees are identical, so one checkpoint serves both.
    serving_preset: str = "exact"
    # enhanced_unet dropout knobs (models.py:265, 291, 295)
    decoder_dropout: float = 0.15
    fusion_dropout: Tuple[float, float] = (0.2, 0.15)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    data_dir: str = "data"
    max_size: int = 640  # train_eval.py:1054
    # deterministic split by sorted filename (dataset.py:38-51)
    split_fractions: Tuple[float, float] = (0.7, 0.15)  # train, val (rest test)
    # XLA needs static shapes: train batches are padded/snap-resized to
    # (max_size, max_size).  The reference instead snaps each image to /32
    # (dataset.py:143-158) producing dynamic shapes; on TPU we use one
    # bucketed shape to avoid recompiles.
    pad_multiple: int = 32


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    num_epochs: int = 50
    batch_size: int = 2  # train_eval.py:1059 (per-replica under DP)
    eval_every_epochs: int = 3  # train_eval.py:1119
    patience: int = 8  # train_eval.py:1097
    early_stop_min_epoch: int = 25  # train_eval.py:1157
    enable_tta: bool = False  # train_eval.py:363 — enhanced_unet only
    seed: int = 0
    # Data parallelism: chips in the Mesh('data') axis.  batch_size above is
    # PER REPLICA (the loader builds global batches of batch_size *
    # num_devices); gradients/BN stats are pmean-reduced over ICI.  1 =
    # single-chip (the reference's only mode).
    num_devices: int = 1

    @property
    def warmup_epochs(self) -> int:
        # train_eval.py:122
        return max(1, min(5, self.num_epochs // 6))

    @property
    def cosine_t0(self) -> int:
        # train_eval.py:126
        return max(10, self.num_epochs // 3)


# The "optimized" serving preset: receipts-approved options that trade
# logit exactness for throughput while keeping the SAME parameter tree
# (a checkpoint trained at the exact placement loads unchanged).
# fusion_stride=2 computes the identical fusion head on 2x-downsampled
# branch logits and bilinearly upsamples the result — the gate, head and
# residual see the same 6-channel signal at ~2.3x fewer total forward
# FLOPs.
SERVING_OPTIMIZED_KWARGS = {
    "enhanced_unet": {"fusion_stride": 2},
}


def _epochs_for(name: str, num_epochs: int) -> int:
    """Per-model epoch scaling (train_eval.py:1058-1069)."""
    if name == "fcn":
        return max(20, num_epochs // 2)
    if name == "linknet":
        return max(15, num_epochs // 3)
    return num_epochs


def _loss_for(name: str) -> LossConfig:
    """Per-model loss bundles (train_eval.py:82-107)."""
    if name == "enhanced_unet":
        return LossConfig(
            dice_weight=2.5,
            focal_weight=2.5,
            tversky_weight=1.0,
            aux_branch_weights=(("unetpp", 0.6), ("deeplab", 0.5)),
            consistency_weight=0.4,
        )
    if name == "fcn":
        return LossConfig(dice_weight=1.0, focal_weight=1.0, tversky_weight=0.3)
    if name == "linknet":
        return LossConfig(dice_weight=0.8, focal_weight=0.8, tversky_weight=0.2)
    return LossConfig(dice_weight=1.5, focal_weight=1.5, tversky_weight=0.5)


def _lr_for(name: str) -> float:
    """Per-model base LR (train_eval.py:112-119)."""
    return {
        "enhanced_unet": 4e-3,
        "fcn": 1e-3,
        "linknet": 8e-4,
    }.get(name, 2e-3)


def get_preset(
    name: str,
    num_epochs: int = 50,
    data_dir: str = "data",
    overrides: Optional[Dict] = None,
) -> TrainConfig:
    """Build the full per-model training preset used by the CLI.

    Replicates the reference's scattered policy tables in one place.
    """
    # *_basic variants (the reference's non-smp fallback architectures)
    # share their parent's policy tables
    base = name[:-6] if name.endswith("_basic") else name
    if base not in MODEL_NAMES:
        raise ValueError(f"Unknown model: {name}; expected one of {MODEL_NAMES}")
    cfg = TrainConfig(
        model=ModelConfig(name=name),
        loss=_loss_for(base),
        optimizer=OptimizerConfig(base_lr=_lr_for(base)),
        data=DataConfig(data_dir=data_dir),
        num_epochs=_epochs_for(base, num_epochs),
        patience=10 if base == "enhanced_unet" else 8,  # train_eval.py:1097
        enable_tta=(base == "enhanced_unet"),
    )
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
