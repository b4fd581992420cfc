"""Checkpoints, ported from `enhanced_unet_tpu/train/checkpoint.py`.

A checkpoint is a directory: `state.pt` (`torch.save` of the step count,
the model's state dict and the optimizer's `AdamWState`) in place of the
JAX package's orbax tree, and `meta.json` with the same fields as the JAX
package's (`epoch`, `best_miou`, `best_loss`, `history`), readable by hand.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import torch

from enhanced_unet_tpu_torch.train.trainer import AdamWState, TrainState


def _meta_path(path: str) -> str:
    return os.path.join(path, "meta.json")


def save_checkpoint(path: str, state: TrainState, epoch: int, best_miou: float,
                    best_loss: float, history: Dict) -> None:
    """Write the train state and its metadata (`history` of numbers and
    lists of them), replacing any checkpoint at `path`."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    opt = state.opt_state
    torch.save({"step": int(state.step), "model": state.model.state_dict(),
                "opt_state": {"count": int(opt.count), "mu": opt.mu, "nu": opt.nu}},
               os.path.join(path, "state.pt"))
    meta = {"epoch": int(epoch), "best_miou": float(best_miou),
            "best_loss": float(best_loss), "history": history}
    with open(_meta_path(path), "w", encoding="utf-8") as f:
        json.dump(meta, f)


def load_checkpoint(path: str, state: TrainState) -> Tuple[TrainState, Dict]:
    """Restore into an existing `TrainState`, on its model's device: the
    weights and running statistics into its model (in place), the step and
    the optimizer state.  Returns (state, meta)."""
    path = os.path.abspath(path)
    device = next(state.model.parameters()).device
    saved = torch.load(os.path.join(path, "state.pt"), map_location=device,
                       weights_only=True)
    state.model.load_state_dict(saved["model"])
    opt = saved["opt_state"]
    meta: Dict = {}
    if os.path.exists(_meta_path(path)):
        with open(_meta_path(path), "r", encoding="utf-8") as f:
            meta = json.load(f)
    state = TrainState(step=int(saved["step"]), model=state.model,
                       opt_state=AdamWState(count=int(opt["count"]), mu=opt["mu"],
                                            nu=opt["nu"]),
                       tx=state.tx)
    return state, meta


def checkpoint_exists(path: str) -> bool:
    return os.path.exists(_meta_path(os.path.abspath(path)))
