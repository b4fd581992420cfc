"""Batch loader, ported from `enhanced_unet_tpu/data/loader.py`: host decode
-> fixed-shape batches -> preprocess and augmentation on the device.

Each batch is made in two halves:

- the host half (`_host_batches`): decode and rasterise the items
  (`CellDataset`), pad them into uint8 staging tensors (pinned when the
  loader feeds a CUDA device), and fix the batch's augmentation seed;
- the device half (`_device_batch`): upload, then the GT-conditioned
  `cell_specific_preprocess` and `augment_train` in train mode, or the
  inference enhance at each image's native size in eval mode.

With `prefetch > 0` a producer thread runs the host half of the next
batches while the consumer trains; the device half always runs in the
consuming thread, so every kernel is queued on the consumer's stream (no
stream is shared across threads).  The batches are the same either way.

Train-time preprocessing sees the padded image, as in the JAX package: for
a dataset of mixed sizes the CLAHE tiles include the padding.  Eval
loaders enhance at native size, per group of same-shape images.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from enhanced_unet_tpu_torch.data.dataset import CellDataset
from enhanced_unet_tpu_torch.device import resolve_device
from enhanced_unet_tpu_torch.ops.augment import augment_train
from enhanced_unet_tpu_torch.ops.preprocess import cell_specific_preprocess, eval_preprocess


def _class_union(item: Dict, label: int) -> np.ndarray:
    """Union of one class's instance masks."""
    h, w = item["semantic_mask"].shape
    out = np.zeros((h, w), np.uint8)
    for m, lab in zip(item["instance_masks"], item["instance_labels"]):
        if lab == label:
            out = np.maximum(out, m)
    return out


class BatchLoader:
    """Fixed-shape batches over a `CellDataset`, on `device` (None: the CUDA
    card, raising without one).

    Each batch is `{"images": [B, H, W, 3] fp32 in [0, 1], "semantic_masks":
    [B, H, W] int64, "valid_mask": [B, H, W] bool, "batch_items": the
    dataset's items, "n_real": how many}`, the tensors on the device and
    padded to `pad_shape`; the last batch is padded with empty images unless
    `drop_remainder`.  Train mode shuffles per epoch and augments with a
    generator seeded from (seed, epoch, batch start, rank).
    `process_shard=(rank, world)` gives each process a disjoint stride of
    the epoch's order, cut so every process yields the same number of
    batches; `batch_size` is then per process."""

    def __init__(self, dataset: CellDataset, batch_size: int, pad_shape: Tuple[int, int],
                 train: bool = False, shuffle: Optional[bool] = None, seed: int = 0,
                 drop_remainder: bool = False, preprocess: bool = True, prefetch: int = 2,
                 process_shard: Optional[Tuple[int, int]] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.pad_shape = pad_shape
        self.train = train
        self.shuffle = train if shuffle is None else shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.preprocess = preprocess
        self.prefetch = prefetch
        self.process_shard = process_shard
        self.device = resolve_device(device)
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.process_shard is not None:
            n = n // self.process_shard[1]
        if self.drop_remainder:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict]:
        if self.prefetch <= 0:
            for host in self._host_batches():
                yield self._device_batch(host)
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        sentinel = object()
        errors: List[BaseException] = []

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for host in self._host_batches():
                    if not put(host):
                        return
            except BaseException as e:  # handed to the consumer, which raises it
                errors.append(e)
            finally:
                put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                host = q.get()
                if host is sentinel:
                    break
                yield self._device_batch(host)
        finally:
            stop.set()
            t.join(timeout=5.0)
        if errors:
            raise errors[0]

    def _staging(self, shape, dtype) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, pin_memory=self.device.type == "cuda")

    def _host_batches(self) -> Iterator[Dict]:
        n = len(self.dataset)
        order = np.arange(n)
        rank = 0
        if self.shuffle:
            # the same order on every process, so the shards are disjoint
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        if self.process_shard is not None:
            rank, world = self.process_shard
            order = order[: n // world * world][rank::world]
            n = len(order)
        self._epoch += 1
        ph, pw = self.pad_shape
        bs = self.batch_size
        gt_masks = self.train and self.preprocess

        for start in range(0, n, bs):
            idxs = order[start:start + bs]
            if self.drop_remainder and len(idxs) < bs:
                break
            items = [self.dataset[int(i)] for i in idxs]
            images = self._staging((bs, ph, pw, 3), torch.uint8)
            masks = self._staging((bs, ph, pw), torch.int64)
            valid = self._staging((bs, ph, pw), torch.bool)
            live = self._staging((bs, ph, pw), torch.uint8) if gt_masks else None
            dead = self._staging((bs, ph, pw), torch.uint8) if gt_masks else None
            for j, item in enumerate(items):
                h, w = item["semantic_mask"].shape
                images.numpy()[j, :h, :w] = item["image_u8"]
                masks.numpy()[j, :h, :w] = item["semantic_mask"]
                valid.numpy()[j, :h, :w] = True
                if gt_masks:
                    live.numpy()[j, :h, :w] = _class_union(item, 0)
                    dead.numpy()[j, :h, :w] = _class_union(item, 1)
            yield {"items": items, "images": images, "masks": masks, "valid": valid,
                   "live": live, "dead": dead,
                   # rank decorrelates the augmentation across processes
                   "seed": hash((self.seed, self._epoch, start, rank)) & 0x7FFFFFFF}

    def _device_batch(self, host: Dict) -> Dict:
        dev = self.device

        def up(t: torch.Tensor) -> torch.Tensor:
            return t.to(dev, non_blocking=True)

        items = host["items"]
        masks = up(host["masks"])
        if self.train and self.preprocess:
            gen = torch.Generator(device=dev).manual_seed(host["seed"])
            images = cell_specific_preprocess(up(host["images"]).float(), up(host["live"]),
                                              up(host["dead"]))
            images, masks = augment_train(gen, images, masks)
            images = images / 255.0
        elif self.preprocess:
            # enhance at native size, so CLAHE's tiles never see the padding:
            # one batched call per group of same-shape images
            images = torch.zeros((*host["images"].shape[:3], 3), dtype=torch.float32,
                                 device=dev)
            groups: Dict[Tuple[int, int], List[int]] = {}
            for j, item in enumerate(items):
                groups.setdefault(tuple(item["semantic_mask"].shape), []).append(j)
            for (h, w), idxs in groups.items():
                native = torch.from_numpy(np.stack([items[j]["image_u8"] for j in idxs]))
                enhanced = eval_preprocess(up(native).float()) / 255.0
                for k, j in enumerate(idxs):
                    images[j, :h, :w] = enhanced[k]
        else:
            images = up(host["images"]).float() / 255.0
        return {"images": images, "semantic_masks": masks, "valid_mask": up(host["valid"]),
                "batch_items": items, "n_real": len(items)}
