"""Seeded inputs and reference runs that the card tests share
(`test_torch_port_gpu.py`) and the serving shapes of the UNet++ decoder's
scSE calls (`test_torch_port_scse.py`).  A helper module: pytest collects
no test from it.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

TINY = ("efficientnet-tiny", "efficientnet-tiny")
STEPS_PER_EPOCH = 10               # the LR table's epoch length
MICROGRAPH_HW = (1024, 1360)       # a common microscope camera frame
CELLS = 40                         # cells a micrograph

# (images, tile) of a tiled 2048^2 request's three forwards with TTA: the
# 75-tile trio at 512^2, then 25 tiles at 384^2 and 25 at 640^2
MIXFFN_FORWARDS = ((75, 512), (25, 384), (25, 640))
# the UNet++ decoder's 21 scSE calls a forward on the B5/B4 flagship
# (`scse_parts`): (part widths, whether the first is the node below read
# through a nearest 2x upsample, the output map's stride); the ten inner
# nodes' attention1, then the eleven nodes' attention2
SCSE_CALLS = (
    ((512, 176), True, 16), ((176, 64), True, 8), ((64, 40), True, 4), ((40, 48), True, 2),
    ((256, 64, 64), True, 8), ((64, 40, 40), True, 4), ((40, 48, 48), True, 2),
    ((128, 40, 40, 40), True, 4), ((40, 48, 48, 48), True, 2),
    ((64, 48, 48, 48, 48), True, 2),
    ((256,), False, 16), ((64,), False, 8), ((40,), False, 4), ((48,), False, 2),
    ((128,), False, 8), ((40,), False, 4), ((48,), False, 2), ((64,), False, 4),
    ((48,), False, 2), ((32,), False, 2), ((16,), False, 1))
SCSE_A_REQUEST = 3 * len(SCSE_CALLS)


def blob_micrograph(rng, size: int):
    """One seeded training micrograph: live (1) and dead (2) disks on a
    textured background.  Returns the grey image [size, size] in [0, 1],
    the int64 mask, and the disks as (pixels, class), in drawing order."""
    yy, xx = np.mgrid[:size, :size]
    img = 0.65 + 0.05 * np.sin(yy / 9.0) + rng.normal(0, 0.02, (size, size))
    mask = np.zeros((size, size), np.int64)
    disks = []
    for _ in range(max(5, size * size // 6000)):
        cy, cx = rng.integers(8, size - 8, 2)
        r, cls = rng.integers(4, 9) * max(1, size // 128), int(rng.integers(1, 3))
        disk = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        img[disk] = 0.5 if cls == 1 else 0.35
        mask[disk] = cls
        disks.append((disk, cls))
    return np.clip(img, 0, 1), mask, disks


def blob_batch(n: int, size: int, pad_to: int, seed: int):
    """Seeded training micrographs with their masks (`blob_micrograph`),
    `size`^2, zero-padded to `pad_to`^2 with `valid` true on the image.
    Returns float32 images [n, pad_to, pad_to, 3] in [0, 1], int64 masks
    and a bool valid mask."""
    rng = np.random.default_rng(seed)
    images = np.zeros((n, pad_to, pad_to, 3), np.float32)
    masks = np.zeros((n, pad_to, pad_to), np.int64)
    valid = np.zeros((n, pad_to, pad_to), bool)
    for i in range(n):
        img, mask, _ = blob_micrograph(rng, size)
        images[i, :size, :size] = img[..., None]
        masks[i, :size, :size] = mask
        valid[i, :size, :size] = True
    return images, masks, valid


def eval_batch(n: int, size: int, seed: int) -> dict:
    """One batch in the loader's format (`{"batch_items": [...], "n_real":
    n}`) of `n` seeded blob micrographs, `size`^2: each item's image
    [size, size, 3] in [0, 1], semantic mask, and one ground-truth instance
    per disk (its pixels no later disk covered; label 0 live, 1 dead)."""
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        img, mask, disks = blob_micrograph(rng, size)
        owner = np.full((size, size), -1)
        for k, (disk, _) in enumerate(disks):
            owner[disk] = k
        inst = [((owner == k).astype(np.uint8), cls - 1) for k, (_, cls) in enumerate(disks)]
        inst = [(m, label) for m, label in inst if m.any()]
        items.append({"image": np.repeat(img[..., None], 3, -1).astype(np.float32),
                      "semantic_mask": mask, "instance_masks": [m for m, _ in inst],
                      "instance_labels": [label for _, label in inst],
                      "image_id": f"blob_{seed}_{i}"})
    return {"batch_items": items, "n_real": n}


def tiny_train_step(cfg, device, dtype, batch) -> dict:
    """One train step of an efficientnet-tiny flagship (seed 5, every rate
    0) in `dtype` on `device`: its loss, its (clipped) gradients and its
    running statistics after the step, in fp64 on the CPU."""
    from enhanced_unet_tpu_torch.models import get_model
    from enhanced_unet_tpu_torch.train.trainer import create_train_state, make_train_step

    model = get_model("enhanced_unet", dtype=dtype, device=device, seed=5,
                      encoder_names=TINY, fusion_dropout=(0.0, 0.0),
                      drop_connect_rate=0.0, aspp_dropout=0.0).to(dtype)
    state = create_train_state(model, cfg, STEPS_PER_EPOCH, device=device)
    images, masks, valid = (torch.from_numpy(a).to(device) for a in batch)
    gen = torch.Generator(device=device).manual_seed(0)
    _, out = make_train_step(cfg)(state, images, masks, valid, gen)
    return {"loss": out["loss"].item(),
            "grads": {n: p.grad.double().cpu() for n, p in model.named_parameters()
                      if p.grad is not None},
            "stats": {n: b.double().cpu() for n, b in model.named_buffers()
                      if "running" in n}}


def tree_rel_l2(ours: dict, ref: dict) -> float:
    num = sum(((ours[k] - v) ** 2).sum().item() for k, v in ref.items())
    den = sum((v ** 2).sum().item() for v in ref.values())
    return (num / max(den, 1e-300)) ** 0.5


def write_micrographs(out_dir: str, n: int, seed: int) -> None:
    """`n` seeded grey micrographs of MICROGRAPH_HW as JPEGs with labelme
    JSON beside them: CELLS live and dead cells each, drawn as disks and
    annotated as polygons of 12-24 points."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = MICROGRAPH_HW
    yy, xx = np.mgrid[:h, :w]
    for i in range(n):
        img = 170 + 15 * np.sin(yy / 37.0) * np.cos(xx / 53.0) + rng.normal(0, 6, (h, w))
        shapes = []
        for _ in range(CELLS):
            cx, cy, r = rng.uniform(30, w - 30), rng.uniform(30, h - 30), rng.uniform(12, 30)
            k = int(rng.integers(12, 25))
            theta = np.sort(rng.uniform(0, 2 * np.pi, k))
            rad = r * rng.uniform(0.8, 1.2, k)
            label = "live" if rng.random() < 0.6 else "dead"
            shapes.append({"label": label, "points": np.stack(
                [cx + rad * np.cos(theta), cy + rad * np.sin(theta)], 1).tolist()})
            box = (slice(max(int(cy - r), 0), int(cy + r) + 2),
                   slice(max(int(cx - r), 0), int(cx + r) + 2))
            disk = (yy[box] - cy) ** 2 + (xx[box] - cx) ** 2 <= r * r
            img[box][disk] = (130 if label == "live" else 90) + rng.normal(0, 4)
        rgb = np.clip(np.repeat(img[..., None], 3, -1), 0, 255).astype(np.uint8)
        name = f"micrograph_{i:03d}.jpg"
        Image.fromarray(rgb).save(os.path.join(out_dir, name), quality=92)
        with open(os.path.join(out_dir, name.replace(".jpg", ".json")), "w") as f:
            json.dump({"shapes": shapes, "imageHeight": h, "imageWidth": w}, f)


def count_plain():
    """K2's and K1's plain versions patched to count their calls: (counts,
    restore)."""
    from enhanced_unet_tpu_torch.ops.kernels import conv_fused, mbconv

    plain = {"conv3x3_bn_act": 0, "mbconv": 0}
    real = (conv_fused.fused_conv3x3_bn_relu_plain, mbconv.mbconv_infer_nchw_plain)

    def counted(name, fn):
        def run(*a, **kw):
            plain[name] += 1
            return fn(*a, **kw)
        return run

    conv_fused.fused_conv3x3_bn_relu_plain = counted("conv3x3_bn_act", real[0])
    mbconv.mbconv_infer_nchw_plain = counted("mbconv", real[1])

    def restore():
        conv_fused.fused_conv3x3_bn_relu_plain, mbconv.mbconv_infer_nchw_plain = real

    return plain, restore


def scse_case(dev, n: int, tile: int, widths, up: bool, stride: int, g):
    """Seeded bf16 channels_last parts of one scSE call on `n` tiles of
    `tile`^2 (the first at half the map when `up`) and its block's folded
    weights (`init_random_weights_` on an `SCSEBlock` of the call's width)."""
    from enhanced_unet_tpu_torch.models import init_random_weights_
    from enhanced_unet_tpu_torch.models.blocks import SCSEBlock

    hw = tile // stride
    parts = []
    for i, c in enumerate(widths):
        side = hw // 2 if up and i == 0 else hw
        parts.append((torch.randn(n, c, side, side, generator=g, device=dev) * 0.5).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last))
    block = init_random_weights_(SCSEBlock(sum(widths)), sum(widths) + stride).to(dev).eval()
    return parts, block
