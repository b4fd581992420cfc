"""Serving pipeline, ported from `enhanced_unet_tpu/train/evaluator.py`
(non-tiled paths): CLAHE+sharpen -> TTA forwards -> threshold cascade.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
import torch.nn as nn

from enhanced_unet_tpu_torch.device import resolve_device
from enhanced_unet_tpu_torch.ops.preprocess import eval_preprocess
from enhanced_unet_tpu_torch.ops.thresholding import convert_probs_to_mask
from enhanced_unet_tpu_torch.ops.tta import tta_probs, tta_probs_batch


class Evaluator:
    """Serve `model` (called as `model(x_nhwc) -> (logits, aux)`).

    TTA is on for `enhanced_unet` unless `enable_tta` says otherwise.
    `device=None` means the CUDA card (raises without one); the model is
    moved there."""

    def __init__(self, model: nn.Module, model_name: str,
                 enable_tta: Optional[bool] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.model_name = model_name
        self.enable_tta = (model_name == "enhanced_unet") if enable_tta is None \
            else enable_tta

    def _apply(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)[0]

    @torch.inference_mode()
    def batch_pipeline(self, imgs: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] float in [0, 1] on the device -> [B, H, W] int32
        masks; every TTA view of every image rides one forward per size."""
        enhanced = eval_preprocess(imgs * 255.0) / 255.0
        probs = tta_probs_batch(self._apply, enhanced, self.enable_tta)
        return convert_probs_to_mask(probs)

    @torch.inference_mode()
    def predict_semantic_mask(self, image01: np.ndarray) -> np.ndarray:
        """[H, W, 3] float in [0, 1] -> int mask [H, W]."""
        img = torch.as_tensor(np.asarray(image01, np.float32), device=self.device)
        enhanced = eval_preprocess(img * 255.0) / 255.0
        probs = tta_probs(self._apply, enhanced, self.enable_tta)
        return convert_probs_to_mask(probs).cpu().numpy()

    def predict_semantic_masks(self, images01: np.ndarray) -> np.ndarray:
        """[B, H, W, 3] float in [0, 1] -> int masks [B, H, W]."""
        imgs = torch.as_tensor(np.asarray(images01, np.float32), device=self.device)
        return self.batch_pipeline(imgs).cpu().numpy()
