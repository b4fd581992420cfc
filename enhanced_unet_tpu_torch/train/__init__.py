"""Training of the PyTorch port (the train and eval steps, the LR table,
checkpoints; `train.api.train_model` is the entry point) and serving (the
Evaluator)."""

from enhanced_unet_tpu_torch.train.schedule import make_lr_fn, reference_lr_schedule
from enhanced_unet_tpu_torch.train.trainer import (
    TrainState,
    create_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from enhanced_unet_tpu_torch.train.evaluator import Evaluator
from enhanced_unet_tpu_torch.train.checkpoint import (
    checkpoint_exists,
    load_checkpoint,
    save_checkpoint,
)

__all__ = [
    "reference_lr_schedule",
    "make_lr_fn",
    "TrainState",
    "create_train_state",
    "make_eval_step",
    "make_optimizer",
    "make_train_step",
    "Evaluator",
    "checkpoint_exists",
    "load_checkpoint",
    "save_checkpoint",
]
