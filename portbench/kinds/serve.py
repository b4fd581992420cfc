"""Serving: one client in a closed loop sends requests of `batch`
micrographs of `image_size`^2 to the program's `Evaluator`
(`predict_semantic_masks`, or with `tiled` `predict_semantic_masks_tiled`
with the traffic's tile, overlap and tile batch), TTA as the traffic says,
and waits for the masks on the host before it sends the next.

The micrographs are a pool made from the seed; request i takes the pool's
slice i mod (pool / batch), the warm-up request the last slice.  For each
slice the run keeps the last request's masks and the probabilities the
timed path handed to its threshold cascade (a reference to the tensor, no
copy); after the window the check compares `check_requests` of the slices
served, drawn from the seed, with the plain reference's.
"""

from __future__ import annotations

import gc
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from portbench import weights as W
from portbench.counters import KernelCalls
from portbench.harness import phase, quantile
from portbench.micrographs import micrographs
from portbench.reference import common

# a density rule's comparison may go either way within this share of pixels
# of its threshold (see `common.admissible_masks`)
RATIO_MARGIN = 0.01
PROB_FLOOR = 1e-6      # log probabilities compared above this
BLOCK = 64             # pixels a side of the blocks whose mean gaps are compared


def pad32(n: int) -> int:
    return -(-n // 32) * 32


class Workload:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        t = cell.traffic
        self.size, self.batch = int(t["image_size"]), int(t["batch"])
        self.slices = int(t["pool"]) // self.batch
        self.tta = bool(t["tta"])
        self.tiled = bool(t.get("tiled", False))
        self.tile, self.overlap = int(t.get("tile", 512)), int(t.get("overlap", 64))
        self.check_requests = int(t["check_requests"])
        self.masks: Dict[int, np.ndarray] = {}
        self.probs: Dict[int, torch.Tensor] = {}
        self.current = None
        self._weights = None
        self.phases: Dict[str, float] = {}

    # -- set-up ------------------------------------------------------------
    def reference_model(self) -> torch.nn.Module:
        return self.cell.reference().build(self.cell.config)

    def weights(self) -> Dict[str, torch.Tensor]:
        """The run's weights (made once, kept on the host)."""
        if self._weights is None:
            self._weights = {n: t.cpu() for n, t in
                             W.seeded_weights(self.cell, self.seed, self.device).items()}
        return self._weights

    def make_inputs(self) -> None:
        images, _ = micrographs(self.slices * self.batch, self.size, self.size, self.seed,
                                self.device)
        self.pool = images.cpu().numpy()

    def setup(self) -> None:
        from enhanced_unet_tpu_torch.models import get_model
        from enhanced_unet_tpu_torch.train import evaluator as ev

        cfg, t = self.cell.config, self.cell.traffic
        with phase(self.phases, "get_model"):
            model = get_model(cfg["model"], num_classes=cfg["num_classes"],
                              dtype=getattr(torch, cfg["dtype"]), device=self.device,
                              **cfg.get("model_kwargs", {}))
        with phase(self.phases, "weights"):
            model.load_state_dict(self.weights())
        self.evaluator = ev.Evaluator(
            model, cfg["model"], enable_tta=self.tta, device=self.device, verbose=False,
            tiled=self.tiled, tile=self.tile, overlap=self.overlap,
            tile_batch=t.get("tile_batch"))
        with phase(self.phases, "inputs"):
            self.make_inputs()
        cascade = ev.convert_probs_to_mask

        def keeping_cascade(probs):
            self.probs[self.current] = probs
            return cascade(probs)

        self._unwrap = (ev, cascade)
        ev.convert_probs_to_mask = keeping_cascade
        with phase(self.phases, "warm_up"):
            self.serve(self.slices - 1)       # the warm-up: every shape of a request
        self.probs.clear()
        self.masks.clear()

    def serve(self, i: int) -> np.ndarray:
        s = i % self.slices
        self.current = s
        images = self.pool[s * self.batch:(s + 1) * self.batch]
        if self.tiled:
            masks = self.evaluator.predict_semantic_masks_tiled(images)
        else:
            masks = self.evaluator.predict_semantic_masks(images)
        self.masks[s] = masks
        return masks

    # -- the window ----------------------------------------------------------
    def step(self, i: int) -> None:
        self.serve(i)

    def end_to_end(self, window: dict) -> Dict[str, float]:
        """The tiled cell's rate has a name of its own: it is device-bound and
        steady, and a bound shared with the host-bound cells would hide a
        loss there."""
        mpix = window["steps"] * self.batch * self.size * self.size / 1e6 / window["window_s"]
        if self.tiled:
            return {"tiled_mpix_per_s": mpix}
        return {"request_p95_ms": quantile(window["latencies"], 0.95) * 1e3,
                "serve_mpix_per_s": mpix}

    def forward_shapes(self) -> list:
        """(n, h, w) of each forward a request makes."""
        if self.tiled:
            n = len(common.tile_starts(max(self.size, self.tile), self.tile,
                                       self.overlap)) ** 2 * self.batch
            h = self.tile
        else:
            n, h = self.batch, self.size
        if not self.tta:
            return [(n, pad32(h), pad32(h))]
        return [(3 * n, pad32(h), pad32(h))] + [(n, pad32(int(h * s)), pad32(int(h * s)))
                                                 for s in (0.75, 1.25)]

    def install_counters(self) -> KernelCalls:
        return KernelCalls()

    def window_counts(self, window: dict) -> dict:
        from portbench.counts.flops import forward_flops

        flops = forward_flops(lambda: self.reference_model(), self.forward_shapes())
        return {"requests": window["steps"], "flops": flops * window["steps"],
                "pixels": window["steps"] * self.batch * self.size ** 2}

    # -- the comparison -------------------------------------------------------
    def release(self) -> None:
        """Free the program's state before the reference runs."""
        unwrap = self.__dict__.pop("_unwrap", None)
        if unwrap is not None:
            unwrap[0].convert_probs_to_mask = unwrap[1]
        self.__dict__.pop("evaluator", None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str) -> torch.nn.Module:
        common.plain_float32()
        model = common.set_precision(self.reference_model(), precision).to(self.device)
        model.load_state_dict(self.weights())
        return model.eval()

    def reference_probs(self, model, s: int) -> torch.Tensor:
        """[batch, C, H, W] reference probabilities of pool slice s."""
        images = self.pool[s * self.batch:(s + 1) * self.batch]
        x = torch.from_numpy(np.stack([common.enhance(im) for im in images])).to(self.device)
        x = x.permute(0, 3, 1, 2).contiguous()

        def forward(v):
            return model(v)[0]

        with torch.inference_mode():
            if self.tiled:
                chunk = int(self.cell.traffic.get("check_chunk", 5))
                return torch.stack([common.tiled_probs(
                    lambda tiles: common.tta_probs(forward, tiles, self.tta), xi,
                    self.tile, self.overlap, chunk) for xi in x])
            return common.tta_probs(forward, x, self.tta)

    def sample(self, slices) -> list:
        """`check_requests` of `slices`, drawn from the seed."""
        slices = sorted(slices)
        g = W.generator(self.seed, "sample", "cpu")
        return sorted(slices[i] for i in
                      torch.randperm(len(slices), generator=g)[:self.check_requests].tolist())

    def control(self):
        """The control in the program's place: the reference with its convs
        computed in fp8 (one scale a tensor), the next precision below the
        configuration's bf16, serving a sample of the pool's slices once."""
        self.make_inputs()
        model = self.reference("fp8")
        for s in self.sample(range(self.slices)):
            probs = self.reference_probs(model, s)
            self.probs[s] = probs.permute(0, 2, 3, 1)
            self.masks[s] = np.stack([common.cascade(p)[0].cpu().numpy() for p in probs])
        del model
        return {"steps": self.slices}

    def check(self, window: dict) -> dict:
        """Over the last masks and probabilities served for a sample of the
        slices that the window served:
        `logprob_gap`, the largest over their images and over blocks of
        `BLOCK` x `BLOCK` pixels of the mean absolute difference of a class's
        log probability (both floored at `PROB_FLOOR`) from the reference's,
        which saturated probabilities do not hide and a fault confined to a
        tile or a corner does not dilute; `mask_mismatch`, the largest share
        of an image's pixels whose class is in none of the reference's
        admissible masks (`common.admissible_masks`).  The image-wide mean
        gap and the widest single gap, which swings from seed to seed, are
        kept in `details`."""
        self.release()
        model = self.reference("fp32")
        gap, mean, widest, worst = 0.0, 0.0, 0.0, 0.0
        for s in self.sample(set(self.probs) & set(self.masks)):
            ref = self.reference_probs(model, s)
            got = self.probs[s].to(self.device).float().permute(0, 3, 1, 2)
            diff = (got.clamp_min(PROB_FLOOR).log() - ref.clamp_min(PROB_FLOOR).log()).abs()
            blocks = F.avg_pool2d(diff.mean(dim=1, keepdim=True), BLOCK, ceil_mode=True)
            gap = max(gap, blocks.max().item())
            mean = max(mean, diff.mean(dim=(1, 2, 3)).max().item())
            widest = max(widest, diff.max().item())
            for mask, p in zip(self.masks[s], ref):
                worst = max(worst, common.mismatch_share(
                    torch.from_numpy(np.asarray(mask)), common.admissible_masks(p, RATIO_MARGIN)))
        self.details = {"logprob_mean": mean, "logprob_widest": widest}
        limits = self.cell.limits
        return {"logprob_gap": {"value": gap, "limit": limits.get("logprob_gap")},
                "mask_mismatch": {"value": worst, "limit": limits.get("mask_mismatch")}}
