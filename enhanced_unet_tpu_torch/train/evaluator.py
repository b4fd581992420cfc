"""Serving and evaluation pipeline, ported from
`enhanced_unet_tpu/train/evaluator.py`:

- inference preprocess (CLAHE + sharpen), TTA forwards for enhanced_unet,
  the threshold cascade: on the device, one upload and one mask download;
- `tiled=True`: full-resolution sliding-window tiling with Hann stitching
  (`ops/tiling.py`), the whole pipeline on the device; with a `mesh` (the
  data axis, `parallel.make_mesh`) the tiles of each chunk split over its
  ranks, gathered and stitched on the host (`predict_probs_tiled`), as the
  JAX Evaluator's mesh path;
- `evaluate`: the reference's metric dict over loader batches: semantic
  metrics, instances (`postprocess/instances.py`), instance metrics, COCO
  mAP over RLE annotations and viability, on the host per image.

Under a profiler each request records a `serve.request` span (`utils.
profiler`) around its stages, `serve.upload`, `serve.preprocess`,
`serve.tiles`, `serve.tta` (`ops/tta.py`), `serve.stitch`, `serve.cascade`
and `serve.download`, and each forward a `model.forward` span.

On a CUDA device `evaluate` takes RLE runs and mask IoUs from the native
host ops (`enhanced_unet_tpu_torch.native`, which raises if it cannot be
built); on the CPU it uses their numpy versions.  Both give the same
numbers.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn as nn

from enhanced_unet_tpu_torch.data.rle import encode_rle, mask_to_bbox
from enhanced_unet_tpu_torch.device import resolve_device
from enhanced_unet_tpu_torch.metrics.coco import calculate_coco_metrics
from enhanced_unet_tpu_torch.metrics.instance import calculate_instance_metrics
from enhanced_unet_tpu_torch.metrics.semantic import calculate_semantic_metrics
from enhanced_unet_tpu_torch.metrics.viability import calculate_viability_metrics
from enhanced_unet_tpu_torch.ops.preprocess import eval_preprocess
from enhanced_unet_tpu_torch.ops.thresholding import convert_probs_to_mask
from enhanced_unet_tpu_torch.ops.tiling import (
    cut_tiles,
    hann_window_2d,
    reflect_pad,
    stitch,
    tile_grid,
)
from enhanced_unet_tpu_torch.ops.tta import run_model_single, tta_probs, tta_probs_batch
from enhanced_unet_tpu_torch.parallel.tiled import map_tiles_sharded
from enhanced_unet_tpu_torch.postprocess.instances import semantic_to_instances
from enhanced_unet_tpu_torch.utils.profiler import span

_METRIC_KEYS = (
    "sem_mean_iou", "sem_mean_dice",
    "sem_background_iou", "sem_background_dice",
    "sem_live_iou", "sem_live_dice", "sem_dead_iou", "sem_dead_dice",
    "live_iou", "live_precision", "live_recall", "live_ap",
    "dead_iou", "dead_precision", "dead_recall", "dead_ap",
    "bbox_mAP", "segm_mAP",
    "viability_accuracy", "pred_viability", "gt_viability",
    "pred_live_count", "pred_dead_count", "gt_live_count", "gt_dead_count",
)


class Evaluator:
    """Serve and evaluate `model` (called as `model(x_nhwc) -> (logits,
    aux)`).

    TTA is on for `enhanced_unet` unless `enable_tta` says otherwise.
    `device=None` means the CUDA card (raises without one); the model is
    moved there.  `tiled=True` serves at full resolution through `tile`
    windows `overlap` pixels apart; `tile_batch` tiles per forward (None:
    all tiles of a call in one forward).  `mesh` (a `parallel.Mesh`, every
    rank calling with the same images; `device` None: the mesh's) shards
    the tiled path's tile chunks over its ranks: `predict_semantic_mask` and
    `evaluate` then take the host-stitched `predict_probs_tiled`;
    `predict_semantic_masks_tiled` ignores it."""

    def __init__(self, model: nn.Module, model_name: str,
                 enable_tta: Optional[bool] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 verbose: bool = True, tiled: bool = False, tile: int = 512,
                 overlap: int = 64, tile_batch: Optional[int] = None, mesh=None):
        self.mesh = mesh
        self.device = resolve_device(mesh.device if device is None and mesh is not None
                                     else device)
        self.model = model.to(self.device).eval()
        self.model_name = model_name
        self.enable_tta = (model_name == "enhanced_unet") if enable_tta is None \
            else enable_tta
        self.verbose = verbose
        self.tiled = tiled
        self.tile, self.overlap, self.tile_batch = tile, overlap, tile_batch

    def _apply(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w = (int(d) for d in x.shape[:3])
        with span("model.forward", device=self.device, n=n, h=h, w=w):
            return self.model(x)[0]

    def _request(self, images: np.ndarray, tiled: bool):
        """The root span of a request of `images` ([B, H, W, 3] or [H, W, 3])."""
        b, h, w = (1, *images.shape[:2]) if images.ndim == 3 else images.shape[:3]
        return span("serve.request", device=self.device, images=int(b), height=int(h),
                    width=int(w), tiled=tiled)

    def update_state(self, state) -> None:
        """Swap in new weights for the same model: the port's `TrainState`
        (its model's) or a state dict.  Copied in place, so the fused
        kernels' cached packs and folds are made again on the next
        forward."""
        sd = state if isinstance(state, Mapping) else state.model.state_dict()
        self.model.load_state_dict(sd)

    @torch.inference_mode()
    def batch_pipeline(self, imgs: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] float in [0, 1] on the device -> [B, H, W] int32
        masks; every TTA view of every image rides one forward per size."""
        enhanced = self._enhance(imgs)
        probs = tta_probs_batch(self._apply, enhanced, self.enable_tta)
        with span("serve.cascade"):
            return convert_probs_to_mask(probs)

    def _upload(self, images01: np.ndarray) -> torch.Tensor:
        with span("serve.upload"):
            return torch.as_tensor(np.asarray(images01, np.float32), device=self.device)

    @staticmethod
    def _enhance(images: torch.Tensor) -> torch.Tensor:
        """CLAHE + sharpen of [..., H, W, 3] images in [0, 1]."""
        with span("serve.preprocess"):
            return eval_preprocess(images * 255.0) / 255.0

    @staticmethod
    def _download(t: torch.Tensor) -> np.ndarray:
        with span("serve.download"):
            return t.cpu().numpy()

    def predict_semantic_mask(self, image01: np.ndarray) -> np.ndarray:
        """[H, W, 3] float in [0, 1] -> mask [H, W]: int32, or uint8 when
        tiled (with a mesh, the cascade on `predict_probs_tiled`'s
        host-stitched probabilities)."""
        if self.tiled and self.mesh is None:
            return self.predict_semantic_masks_tiled(np.asarray(image01)[None])[0]
        with torch.inference_mode(), self._request(np.asarray(image01), self.tiled):
            if self.tiled:
                probs = self._host_tiled_probs(image01)
                with span("serve.upload"):
                    probs = torch.from_numpy(probs).to(self.device)
                with span("serve.cascade"):
                    mask = convert_probs_to_mask(probs).to(torch.uint8)
            else:
                enhanced = self._enhance(self._upload(image01))
                probs = tta_probs(self._apply, enhanced, self.enable_tta)
                with span("serve.cascade"):
                    mask = convert_probs_to_mask(probs)
            return self._download(mask)

    def predict_semantic_masks(self, images01: np.ndarray) -> np.ndarray:
        """[B, H, W, 3] float in [0, 1] -> int masks [B, H, W]."""
        with self._request(np.asarray(images01), False):
            return self._download(self.batch_pipeline(self._upload(images01)))

    def _tile_probs(self, tiles: torch.Tensor) -> torch.Tensor:
        """[n, tile, tile, 3] enhanced tiles -> [n, tile, tile, C]
        probabilities: the TTA views of every tile (as `vmap(tta_probs)`
        over the tiles), or one softmaxed forward."""
        if self.enable_tta:
            return tta_probs_batch(self._apply, tiles, True)
        with span("serve.tta", views=1):
            return torch.softmax(self._apply(tiles).float(), dim=-1)

    def tiled_probs(self, enhanced: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] enhanced images on the device -> [B, H, W, C]
        probabilities, stitched on the device: every image's tiles, in
        forwards of `tile_batch` tiles (all at once when None)."""
        b, h, w = (int(s) for s in enhanced.shape[:3])
        with span("serve.tiles"):
            ph, pw, positions = tile_grid(h, w, self.tile, self.overlap)
            tiles = cut_tiles(reflect_pad(enhanced, ph, pw), positions, self.tile)
        bs = self.tile_batch or tiles.shape[0]
        chunks = [self._tile_probs(tiles[s:s + bs]) for s in range(0, tiles.shape[0], bs)]
        with span("serve.stitch"):
            window = torch.from_numpy(hann_window_2d(self.tile))[..., None].to(self.device)
            probs = torch.cat(chunks).reshape(b, len(positions), *chunks[0].shape[1:])
            return stitch(probs, positions, ph, pw, window)[:, :h, :w]

    @torch.inference_mode()
    def predict_semantic_masks_tiled(self, images01: np.ndarray) -> np.ndarray:
        """[B, H, W, 3] float in [0, 1] -> uint8 masks [B, H, W] at full
        resolution: enhance, the tile grid, the tile forwards (TTA per tile
        when enabled), Hann stitching and the cascade on the device; one
        upload, one download."""
        with self._request(np.asarray(images01), True):
            probs = self.tiled_probs(self._enhance(self._upload(images01)))
            with span("serve.cascade"):
                mask = convert_probs_to_mask(probs).to(torch.uint8)
            return self._download(mask)

    @torch.inference_mode()
    def predict_probs_tiled(self, image01: np.ndarray) -> np.ndarray:
        """[H, W, 3] float in [0, 1] -> [H, W, C] full-resolution
        probabilities (numpy), the tiles forwarded in batches of
        `tile_batch or 8` and stitched on the host.  With a mesh the batch
        is rounded up to the mesh's size and down to a multiple of it, the
        tiles padded with zero tiles to a multiple of the batch, and each
        batch split over the ranks (`parallel.tiled.map_tiles_sharded`)."""
        with self._request(np.asarray(image01), True):
            return self._host_tiled_probs(image01)

    def _host_tiled_probs(self, image01: np.ndarray) -> np.ndarray:
        enhanced = self._enhance(self._upload(image01))
        h, w = int(enhanced.shape[0]), int(enhanced.shape[1])
        with span("serve.tiles"):
            ph, pw, positions = tile_grid(h, w, self.tile, self.overlap)
            tiles = cut_tiles(reflect_pad(enhanced, ph, pw)[None], positions, self.tile)
        n = tiles.shape[0]
        bs = self.tile_batch or 8
        if self.mesh is None:
            chunks = [self._tile_probs(tiles[s:s + bs]) for s in range(0, n, bs)]
        else:
            bs = max(bs, self.mesh.size)
            bs -= bs % self.mesh.size
            if n % bs:
                tiles = torch.cat([tiles, tiles.new_zeros((bs - n % bs, *tiles.shape[1:]))])
            chunks = [map_tiles_sharded(self._tile_probs, tiles[s:s + bs], self.mesh)
                      for s in range(0, tiles.shape[0], bs)]
        probs = np.concatenate([self._download(c) for c in chunks])[:n]
        with span("serve.stitch"):
            t = self.tile
            window = hann_window_2d(t)[..., None]
            acc = np.zeros((ph, pw, probs.shape[-1]), np.float32)
            wacc = np.zeros((ph, pw, 1), np.float32)
            for i, (y, x) in enumerate(positions):
                acc[y:y + t, x:x + t] += probs[i] * window
                wacc[y:y + t, x:x + t] += window
            return (acc / np.maximum(wacc, 1e-8))[:h, :w]

    @torch.inference_mode()
    def predict_probs(self, image01: np.ndarray) -> np.ndarray:
        """Raw softmax probabilities [H, W, C] (no enhance, no TTA) for
        ROC/PR plots (train_eval.py:1291-1306)."""
        return run_model_single(self._apply, self._upload(image01)).cpu().numpy()

    def evaluate(self, loader: Iterable[Dict]) -> Dict[str, float]:
        """The reference's metric dict (train_eval.py:852-1021) over loader
        batches (`{"batch_items": [...], "n_real": n}`, each item with
        `image`, `semantic_mask`, `instance_masks`, `instance_labels`)."""
        native = self.device.type == "cuda"
        all_metrics: Dict[str, List[float]] = {k: [] for k in _METRIC_KEYS}
        pred_annotations: List[Dict] = []
        gt_annotations: List[Dict] = []
        image_counter = 0

        for batch in loader:
            items = batch["batch_items"][: batch["n_real"]]
            # the device half by shape group, one forward per group of two or
            # more; the host half per image below
            preds: List[Optional[np.ndarray]] = [None] * len(items)
            if not self.tiled and len(items) > 1:
                groups: Dict[tuple, List[int]] = {}
                for idx, item in enumerate(items):
                    groups.setdefault(tuple(np.asarray(item["image"]).shape), []).append(idx)
                for idxs in groups.values():
                    if len(idxs) == 1:
                        continue
                    imgs = np.stack([np.asarray(items[j]["image"], np.float32) for j in idxs])
                    for j, m in zip(idxs, self.predict_semantic_masks(imgs)):
                        preds[j] = m

            for i, item in enumerate(items):
                image01 = np.asarray(item["image"], np.float32)
                gt_masks = item["instance_masks"]
                gt_labels = item["instance_labels"]
                img_id = image_counter
                image_counter += 1
                pred_semantic = (preds[i] if preds[i] is not None
                                 else self.predict_semantic_mask(image01))

                for k, v in calculate_semantic_metrics(
                        pred_semantic, np.asarray(item["semantic_mask"])).items():
                    if k in all_metrics:
                        all_metrics[k].append(v)

                pred_masks, pred_labels, pred_scores = semantic_to_instances(pred_semantic)
                pred_live = sum(1 for label in pred_labels if label == 0)
                pred_dead = sum(1 for label in pred_labels if label == 1)
                gt_live = sum(1 for label in gt_labels if label == 0)
                gt_dead = sum(1 for label in gt_labels if label == 1)
                if self.verbose and image_counter <= 3:
                    # first-3-image diagnostics (reference train_eval.py:921-937)
                    live_px = int((pred_semantic == 1).sum())
                    dead_px = int((pred_semantic == 2).sum())
                    print(f"[debug] image {image_counter} "
                          f"({item.get('image_id', 'unknown')}): "
                          f"live_px={live_px} dead_px={dead_px} "
                          f"pred live/dead={pred_live}/{pred_dead} "
                          f"gt live/dead={gt_live}/{gt_dead}")
                    if live_px > 0 and pred_live == 0:
                        print(f"  WARNING: {live_px} live pixels but no "
                              "live instances detected")
                    if dead_px > 0 and pred_dead == 0:
                        print(f"  WARNING: {dead_px} dead pixels but no "
                              "dead instances detected")

                for k, v in calculate_instance_metrics(
                        pred_masks, pred_labels, pred_scores, gt_masks, gt_labels,
                        native=native).items():
                    if k in all_metrics:
                        all_metrics[k].append(v)

                for mask, label, score in zip(pred_masks, pred_labels, pred_scores):
                    pred_annotations.append({
                        "image_id": img_id, "category_id": int(label),
                        "bbox": mask_to_bbox(mask),
                        "segmentation": encode_rle(mask, native),
                        "score": float(score), "area": int(mask.sum())})
                for mask, label in zip(gt_masks, gt_labels):
                    gt_annotations.append({
                        "image_id": img_id, "category_id": int(label),
                        "bbox": mask_to_bbox(mask),
                        "segmentation": encode_rle(np.asarray(mask), native),
                        "area": int(np.asarray(mask).sum()), "iscrowd": 0})

                for k, v in calculate_viability_metrics(
                        pred_live, pred_dead, gt_live, gt_dead).items():
                    if k in all_metrics:
                        all_metrics[k].append(v)

        if pred_annotations and gt_annotations:
            coco = calculate_coco_metrics(pred_annotations, gt_annotations)
            all_metrics["bbox_mAP"] = [coco["bbox_mAP"]]
            all_metrics["segm_mAP"] = [coco["segm_mAP"]]
        return {k: (float(np.mean(v)) if v else 0.0) for k, v in all_metrics.items()}
