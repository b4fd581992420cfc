"""Drive the PyTorch port's serving and training paths on one CUDA card, end
to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
 1. the card (`nvidia-smi` name and power limit), torch and CUDA versions;
 2. build every CUDA kernel from `enhanced_unet_tpu_torch/csrc/` (one nvcc
    per source, in parallel), timed;
 3. hold each kernel against its plain PyTorch version at the shapes the
    serving path gives it (bf16; the conv kernel also fp32 with TF32 off),
    and time kernel (held, and unheld: `wall_ms`, with the host's cost per
    call), plain version, and the library call where one exists.  K2
    (`conv3x3_bn_act`) at the four widest serving shapes, each beside its
    `mma.sync` kernel (the general bf16 path) on the same inputs, and that
    general path driven once through the public entry.  K1 (`mbconv`) at
    the two stage-0 serving shapes on channels_last inputs through its
    `nhwc` kernels and at a B5 stage-1 expand block (`[6,40,128,128]` mid
    240) through its `nhwc_expand` kernels, each pass beside the `nchw`
    kernels on an NCHW copy of the same values, at 8- and 16-row tiles,
    and beside the library's channels_last block (several calls); and on
    the `nchw` kernels the same stage-1 block in fp32, stage 0's two blocks
    in fp32 and a stage-3 (128 -> 768 -> 128 at 32^2) and a stage-6 block
    (512 -> 3072 -> 512 at 16^2) in bf16, each beside its plain version,
    the library block and its bound (bf16 within 2e-2 of max |value|, fp32
    within 1e-4);
 3b. the kernel benches (`enhanced_unet_tpu_torch.benchmarks`): every launch
    count set to 0, then the `main()` of `dw_variants` and `mbconv_instr`
    and `mbconv_proto`'s two cases one by one, at their full shapes, which
    hold each kernel against its plain version and time it; every
    depthwise, copy and MBConv count must move (B1 stage 0 reaches K1's
    `nhwc` kernels, stage 1 the `nhwc_expand` ones, B2's passes the `nchw`
    ones).  The benches' rows give the kernels' entries (B2's bf16 passes
    their own, beside the library's channels_last block on the same
    values), each depthwise kernel's `copy_ratio` (its held time over the
    copy kernel's) and the copy's measured bandwidth beside
    `Tensor.copy_`'s; then `dw3x3_bias_silu` with fp32 weights (the
    wrapper's cast in every call), and both depthwise kernels on the 2-byte
    path (odd W, a misaligned start) and at W = 520, against their plain
    versions;
 4. the slice: `get_model("enhanced_unet")` at full width (EfficientNet-B5
    UNet++ + EfficientNet-B4 DeepLabV3+, bf16, seeded random weights) served
    by an `Evaluator` with TTA: three requests of two 512x512 images; every
    count set to 0 before it; the serving kernels' counts (K2's wgmma and
    small-Cin variants, K1's two `nhwc` passes) must move and every other
    count (K1's `nhwc_expand` and `nchw` kernels among them: the bf16
    request launches no `nchw` kernel) must not; the first request
    records each shape K2 and K1 are called at, and no request after it may
    pack a conv's weights or fold an MBConv block's again; every K1 input
    must come channels_last with its folded weights already on the card; a
    profile;
 4b. K2 at every recorded serving shape (66: 22 per forward, three TTA
    forwards): checked against its plain version, timed (20 calls) beside
    the plain version, the `mma.sync` kernel, cuDNN + a torch epilogue and
    cuDNN's channels_last conv alone, and summed over one request
    (launches x time) beside the same sum of its bounds and the profiled
    K2 group (`--k2-json PATH` also writes these rows to PATH);
 4c. K1 at every recorded serving shape (6: 2 per forward; 30 launches a
    request): each pass checked against its plain version and timed beside
    it, the `nchw` kernels and the library block, and summed over one
    request beside the bounds' sum and the profiled K1 group;
 4d. K1's `nhwc_expand` kernels, which serving does not route to, at the
    six stride-1 expand-block shapes of stage 1 in one request (B5:
    `[6,40,128,128]`, `[2,40,96,96]`, `[2,40,160,160]`, mid 240; B4: the
    same with 32 channels, mid 192; all residual): each pass checked
    against its plain version and timed (8- and 16-row tiles) beside the
    `nchw` kernels, the library block and the bound, the two passes faster
    than the `nchw` pair; the entry `mbconv_infer_nchw` (both passes and
    the SE gate between them) timed beside the stock path's eval-mode
    `MBConvBlock` on the same weights (what serving runs); and the sums
    over one request (4 blocks of each B5 shape and 3 of each B4 shape);
 4e. tiled serving at full width: the same model served by an `Evaluator`
    with `tiled=True` (tile 512, overlap 64, TTA, the whole grid in one
    chunk) on one seeded 2048x2048 micrograph, three requests, every count
    set to 0 before each: a [2048,2048] uint8 mask with at least two
    classes; the 25 tiles in three forwards (the 75-tile trio, 25 at 384^2,
    25 at 640^2); K2's wgmma/small-Cin and K1's `nhwc` counts move, no
    other; no pack or fold after the first request; wall ms, CUDA-event
    span, peak memory, launches per request, the shapes K1 and K2 were
    called at, a profile; the host-stitched path (chunks of 8) and
    `tile_batch=8` against the whole-grid mask (at least 99.99% of pixels
    equal, the share printed); K2 at the trio's three fusion-head shapes
    (`[75,512,512,Cin]`, up to 5.0e9 elements) against its plain version
    (2e-2 of max |value|) and timed (held and `wall_ms`), beside cuDNN's
    conv + BN + ReLU as one PyTorch call chain on the same inputs;
 4g. `evaluate` on the card: one loader-format batch of two 512^2 blob
    micrographs with their disks as ground-truth instances; every metric
    key present and finite, the predicted live/dead counts those of
    `semantic_to_instances` on the masks the card returned, the native host
    ops built and called; the host's ms per image;
 5. cross-check: one 256x256 image, one view, bf16 on the card against the
    same weights in fp32 on the CPU (plain PyTorch path); and 4f, the tiled
    path on one 256x448 image (tile 256, overlap 64: two tiles, one view),
    its probabilities within 5e-2 of max |value| of the CPU's;
 6. the training step (`train.trainer`):
    6a. the flagship at full width (bf16 compute, fp32 parameters,
        `fusion_stride=1`, the preset's dropout and stochastic depth) in
        train mode takes 1 warm and 5 timed steps of 2 seeded 512^2 blob
        micrographs padded to 640^2 (the JAX trainer's batch): wall and
        device ms, peak memory and loss of each step, one more step under
        the profiler; every loss finite, after the first step every called
        parameter with a finite gradient, not all zero but where stochastic
        depth dropped its block for both samples or a dead scSE ReLU zeroes
        it, parameters and running statistics changed, and no K1 or K2
        launch (training takes the stock path);
    6b. `make_eval_step` on the trained model: K1 and K2 launch, each
        confusion matrix sums to 640^2, and an eval-mode forward with grad
        enabled raises;
    6c. one step of an efficientnet-tiny flagship (64^2, batch 2, every
        rate 0, the same weights) on the card against the CPU, in fp32
        (loss within rtol 1e-4, running statistics within 1e-4, the
        gradient tree within relative L2 1e-3, or 3x the CPU's own
        fp32-to-fp64 distance where that is larger: train-mode BatchNorm
        at batch 2 makes fp32 gradients noise-limited) and in fp64
        (gradient tree within 1e-4);
 7. the training entry point (`train.api.train_model`) at full width:
    12 seeded 1360 x 1024 micrographs (JPEG, labelme JSON, 40 cells of
    12-24 points each) split 8 / 1 / 3 and snapped to 640 x 480; the host's
    ms per item (decode, resize, raster); 3 epochs of batch 2 padded to
    640^2 with the full-Evaluator gate after the third (best_model and
    last_model written, three finite losses, one val mIoU, K1 and K2
    launched in the gate, its wall ms); a resume to epoch 4 (the step and
    epoch restored, parameters and AdamW moments bitwise equal to the saved
    state, epoch 4 only); one 2 x 640^2 batch through
    `cell_specific_preprocess` and `apply_augment` on the card against the
    CPU with the same draws (masks equal; the preprocess within 16 levels
    and 0.9 of values equal, the bounds JAX's own jitted run keeps from its
    op-by-op run on the CPU tests' inputs, 11 levels and 0.91; the
    augmentation on the same input within 3 levels and 0.99 equal), its
    device ms; the step's wall ms over whole epochs with `prefetch=2` and
    `prefetch=0`; a profile of one epoch; peak memory;
 8. a `{"kernels": [...]}` line, each entry's launches counted in the run
    whose time and shape it reports (the serving kernels' also per tiled
    request, `tiled_launches`), the card line, and the final JSON line.

It needs no network and builds into `build/kernels/`.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS = {"bf16": 989e12, "fp32": 67e12}   # dense tensor-core bf16; fp32 CUDA cores
K2_ITERS = 20                      # calls per K2 timing
K1_ITERS = 20                      # calls per K1 timing
TRAIN_STEPS = 5                    # timed full-width train steps, after 1 warm step
TILED_SIZE, TILE, TILE_OVERLAP = 2048, 512, 64   # phase 4e: a full-resolution micrograph
TRAIN_SIZE, TRAIN_PAD = 512, 640   # micrographs, padded to the trainer's max_size
STEPS_PER_EPOCH = 10               # the LR table's epoch length
TINY = ("efficientnet-tiny", "efficientnet-tiny")
# the UNet++ head block's attention1 exists (reference state dict) but is
# never called
UNCALLED = "unetpp.decoder.blocks.x_0_4.attention1."
# stage 1's stride-1 expand blocks in one 2 x 512^2 TTA request (stride 4:
# the trio at 128^2, 2 images at 96^2 and at 160^2): (n, Cin, H = W) ->
# blocks of that shape per forward (B5: 40 channels, 4 blocks; B4: 32, 3)
EXPAND_SERVING = {(6, 40, 128): 4, (2, 40, 96): 4, (2, 40, 160): 4,
                  (6, 32, 128): 3, (2, 32, 96): 3, (2, 32, 160): 3}


def bound(bytes_moved: float, ops: float, kind: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def reset(counters) -> None:
    for counter in counters:
        for name in counter:
            counter[name] = 0


def synthetic_images(n: int, size: int, seed: int):
    """Seeded micrograph-like images in [0, 1]: blobs on a noisy field."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    out = []
    for _ in range(n):
        img = 120 + 30 * np.sin(yy / rng.uniform(6, 12)) * np.cos(xx / rng.uniform(6, 12))
        for _ in range(40):
            cy, cx, r = rng.uniform(0, size, 2).tolist() + [rng.uniform(6, 20)]
            img = img + 60 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
        img = img[..., None] + rng.normal(0, 10, size=(size, size, 3))
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return np.stack(out).astype(np.float32) / 255.0


def serving_model(**kwargs):
    """The full-width flagship with seeded random weights.  Its two output
    convs are scaled up so the logits reach a few units and the threshold
    cascade makes real decisions: with the seeded weights alone the logits
    stay below about 0.25 in magnitude, which the cascade maps to background
    everywhere."""
    import torch

    from enhanced_unet_tpu_torch.models import get_model

    model = get_model("enhanced_unet", seed=0, **kwargs)
    with torch.no_grad():
        for layer in (model.fusion_head[11], model.fusion_residual):
            layer.weight.mul_(20.0)
    return model


def blob_micrograph(rng, size: int):
    """One seeded training micrograph: live (1) and dead (2) disks on a
    textured background.  Returns the grey image [size, size] in [0, 1],
    the int64 mask, and the disks as (pixels, class), in drawing order."""
    import numpy as np

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
    import numpy as np

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
    import numpy as np

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


TRAIN_GROUPS = (("batch norm", ("batch_norm", "bn_fw", "bn_bw")),
                ("optimizer (foreach)", ("multi_tensor_apply", "foreach")))


def profile_run(run, wall_ms: float, what: str, extra_groups=()) -> dict:
    """Device time of `run()` by kernel group and by kernel
    (torch.profiler), and the device's idle share of `wall_ms`, its wall
    time measured without the profiler.  `extra_groups` ((label, name
    fragments), ...) are matched before the default groups.  Returns the
    milliseconds by group (empty when nothing was recorded)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    groups, kernels, group_launches = {}, {}, {}
    total = 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0) or getattr(
            ev, "self_cuda_time_total", 0)
        if us <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = ev.key
        extra = [label for label, parts in extra_groups
                 if any(t in name.lower() for t in parts)]
        group = (extra[0] if extra else
                 "conv3x3_bn_act (K2)" if "conv3x3_bn_act" in name else
                 "mbconv (K1)" if "mbconv" in name else
                 "cuDNN/cuBLAS conv and matmul" if any(
                     t in name.lower() for t in ("conv", "gemm", "sm90", "xmma", "cudnn", "cutlass"))
                 else "other PyTorch kernels")
        groups[group] = groups.get(group, 0.0) + us / 1e3
        group_launches[group] = group_launches.get(group, 0) + ev.count
        kernels[name] = (kernels.get(name, (0.0, 0))[0] + us / 1e3,
                         kernels.get(name, (0.0, 0))[1] + ev.count)
        total += us / 1e3
    if total <= 0:
        print("profile: no device time recorded (not measured)")
        return {}
    parts = ", ".join(f"{k} {v:.1f} ms ({100 * v / total:.0f}%, {group_launches[k]} launches)"
                      for k, v in sorted(groups.items(), key=lambda kv: -kv[1]))
    print(f"profile of {what}: device time {total:.1f} ms of {wall_ms:.1f} ms "
          f"wall (device idle share {1 - total / wall_ms:.2f}): {parts}")
    for name, (ms, count) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  {ms:8.3f} ms {count:5d} launches  {name[:110]}")
    host = sorted(((ev.self_cpu_time_total / 1e3, ev.count, ev.key) for ev in prof.key_averages()
                   if ev.self_cpu_time_total > 0), reverse=True)
    print(f"host time by op (self, under the profiler): total "
          f"{sum(h[0] for h in host):.1f} ms; top: " + "; ".join(
              f"{key[:48]} {ms:.1f} ms x{count}" for ms, count, key in host[:10]))
    return groups


def record_dropped_blocks(model):
    """Record, for the next forward, the MBConv blocks whose residual
    branch stochastic depth dropped for every sample.  Returns (the set of
    their names, filled as the forward runs; `undo()` to stop)."""
    from enhanced_unet_tpu_torch.models import encoders

    dropped, current = set(), [None]
    hooks = [m.register_forward_pre_hook(lambda mod, args, name=n: current.__setitem__(0, name))
             for n, m in model.named_modules() if isinstance(m, encoders.MBConvBlock)]
    drop_path = encoders.drop_path

    def recording_drop_path(y, rate, generator):
        out = drop_path(y, rate, generator)
        if not out.flatten(1).abs().amax(1).gt(0).any().item():
            dropped.add(current[0])
        return out

    def undo():
        encoders.drop_path = drop_path
        for h in hooks:
            h.remove()

    encoders.drop_path = recording_drop_path
    return dropped, undo


def check_gradients(model, dropped) -> None:
    """After a train step: every called parameter has a finite gradient,
    not all zero unless stochastic depth dropped its MBConv block's branch
    for every sample (then exactly zero) or a dead ReLU in an scSE channel
    gate zeroed it (its reduce conv and its expand weight; the expand bias
    still gets one), and the never-called head attention has none."""
    import torch

    named = [(n, p) for n, p in model.named_parameters() if not n.startswith(UNCALLED)]
    missing = [n for n, p in named if p.grad is None]
    check(not missing, f"parameters without a gradient: {missing[:5]}")
    check(all(p.grad is None for n, p in model.named_parameters() if n.startswith(UNCALLED)),
          "the never-called head attention has no gradient")
    finite = torch.stack([torch.isfinite(p.grad).all() for _, p in named]).tolist()
    check(all(finite), "finite gradients")
    amax = torch.stack([p.grad.abs().amax().float() for _, p in named]).tolist()
    zero = {n for (n, _), a in zip(named, amax) if a == 0}
    in_dropped = {n for n, _ in named if any(n.startswith(b + ".") for b in dropped)}
    check(in_dropped <= zero, f"gradients in fully dropped blocks: {sorted(in_dropped - zero)}")
    gated = {n for n in zero - in_dropped if ".cSE.1." in n or n.endswith(".cSE.3.weight")}
    check(zero == gated | in_dropped,
          f"all-zero gradients outside dropped blocks and scSE gates: "
          f"{sorted(zero - gated - in_dropped)}")
    check(all(n.rsplit(".cSE.", 1)[0] + ".cSE.3.bias" not in zero for n in gated),
          "a gate whose ReLU is dead still passes a gradient to its expand bias")
    print(f"gradients after the first step: {len(named)} called parameters, all finite, "
          f"{len(named) - len(zero)} not all zero; {len(in_dropped)} in the {len(dropped)} "
          f"blocks stochastic depth dropped for both samples {sorted(dropped)}; "
          f"{len(gated)} zeroed by dead scSE ReLUs {sorted(gated)}")


def tiny_train_step(cfg, device, dtype, batch) -> dict:
    """One train step of an efficientnet-tiny flagship (seed 5, every rate
    0) in `dtype` on `device`: its loss, its (clipped) gradients and its
    running statistics after the step, in fp64 on the CPU."""
    import torch

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


MICROGRAPH_HW = (1024, 1360)   # phase 7: a common microscope camera frame
MICROGRAPHS, CELLS = 12, 40    # train 8 / val 1 / test 3; cells a micrograph
ENTRY_MAX_SIZE = 640           # the trainer's max_size: 1360 x 1024 -> 640 x 480
ENTRY_STEPS = 4                # train steps an epoch: 8 micrographs, batch 2


def write_micrographs(out_dir: str, n: int, seed: int) -> None:
    """`n` seeded grey micrographs of MICROGRAPH_HW as JPEGs with labelme
    JSON beside them: CELLS live and dead cells each, drawn as disks and
    annotated as polygons of 12-24 points."""
    import os

    import numpy as np
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


def host_ms_per_item(ds) -> dict:
    """The host half of an item, by stage, in ms per item over `ds`: decode
    (Pillow), the /32 resize, and the polygons' raster."""
    import os

    import numpy as np

    from enhanced_unet_tpu_torch.data import dataset

    ms = {"decode": 0.0, "resize": 0.0, "raster": 0.0, "item": 0.0}
    for i, name in enumerate(ds.files):
        t0 = time.perf_counter()
        image = dataset._read_rgb(os.path.join(ds.data_dir, name))
        t1 = time.perf_counter()
        h, w = dataset.snap_to_multiple(*image.shape[:2], ds.max_size)
        dataset._resize_image(image, (w, h))
        t2 = time.perf_counter()
        with open(os.path.join(ds.data_dir, name.replace(".jpg", ".json"))) as f:
            shapes = json.load(f)["shapes"]
        for shape in shapes:
            pts = np.asarray(shape["points"], np.float32)
            pts[:, 0] *= w / image.shape[1]
            pts[:, 1] *= h / image.shape[0]
            dataset._fill_polygon(np.zeros((h, w), np.uint8), pts.astype(np.int32))
        t3 = time.perf_counter()
        ds[i]
        t4 = time.perf_counter()
        for key, dt in zip(ms, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            ms[key] += 1e3 * dt / len(ds.files)
    return ms


def phase7_training_entry(card: str, counters, dev) -> None:
    """7. The training entry point on the card: `train_model` from a folder
    of micrographs, its gate, resume, the device pipeline against the CPU,
    and the step with and without prefetch (see the module docstring)."""
    import dataclasses
    import os
    import tempfile

    import numpy as np
    import torch

    from enhanced_unet_tpu_torch.benchmarks.microtime import device_ms
    from enhanced_unet_tpu_torch.config import get_preset
    from enhanced_unet_tpu_torch.data.dataset import CellDataset, snap_to_multiple
    from enhanced_unet_tpu_torch.data.loader import BatchLoader, _class_union
    from enhanced_unet_tpu_torch.ops.augment import apply_augment, augment_params
    from enhanced_unet_tpu_torch.ops.kernels import conv_fused, mbconv
    from enhanced_unet_tpu_torch.ops.preprocess import cell_specific_preprocess
    from enhanced_unet_tpu_torch.train import api
    from enhanced_unet_tpu_torch.train.evaluator import Evaluator
    from enhanced_unet_tpu_torch.train.trainer import make_train_step

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        data_dir, ckpt_dir = os.path.join(tmp, "micrographs"), os.path.join(tmp, "ckpt")
        os.makedirs(data_dir)
        t0 = time.perf_counter()
        write_micrographs(data_dir, MICROGRAPHS, 31)
        splits = {s: CellDataset(data_dir, s, max_size=ENTRY_MAX_SIZE)
                  for s in ("train", "val", "test")}
        train_ds = splits["train"]
        check([len(d) for d in splits.values()] == [8, 1, 3], "the 70/15/15 split: 8 / 1 / 3")
        item = train_ds[0]
        snapped = snap_to_multiple(*MICROGRAPH_HW, ENTRY_MAX_SIZE)
        check(item["semantic_mask"].shape == snapped
              and item["original_size"] == MICROGRAPH_HW
              and len(item["instance_masks"]) >= CELLS // 2,
              f"a {MICROGRAPH_HW} micrograph snaps to {snapped} with its cells")
        host = host_ms_per_item(train_ds)
        print(f"[{card}] training data: {MICROGRAPHS} micrographs {MICROGRAPH_HW[1]} x "
              f"{MICROGRAPH_HW[0]} written in "
              f"{time.perf_counter() - t0:.1f} s; host ms per item (8 items): "
              + ", ".join(f"{k} {v:.1f}" for k, v in host.items()))

        # first run: 3 epochs, the full-Evaluator gate after the third
        cfg = dataclasses.replace(get_preset("enhanced_unet"), num_epochs=3, eval_every_epochs=3)
        gates, saved, restored, logs = [], {}, {}, []
        real_evaluate, real_save, real_load = (Evaluator.evaluate, api.save_checkpoint,
                                               api.load_checkpoint)

        def timed_evaluate(self, loader):
            reset(counters)
            t0 = time.perf_counter()
            out = real_evaluate(self, loader)
            torch.cuda.synchronize()
            gates.append((1e3 * (time.perf_counter() - t0),
                          {**conv_fused.LAUNCHES, **mbconv.LAUNCHES}))
            return out

        def recording_save(path, state, *args):
            real_save(path, state, *args)
            if path.endswith("last_model"):
                saved.update(step=state.step,
                             model={k: v.clone() for k, v in state.model.state_dict().items()},
                             mu={k: v.clone() for k, v in state.opt_state.mu.items()},
                             nu={k: v.clone() for k, v in state.opt_state.nu.items()})

        def recording_load(path, state):
            state, meta = real_load(path, state)
            sd = state.model.state_dict()
            restored.update(
                step=state.step, epoch=meta["epoch"],
                model=all(torch.equal(sd[k], v) for k, v in saved["model"].items()),
                mu=all(torch.equal(state.opt_state.mu[k], v) for k, v in saved["mu"].items()),
                nu=all(torch.equal(state.opt_state.nu[k], v) for k, v in saved["nu"].items()))
            return state, meta

        Evaluator.evaluate, api.save_checkpoint = timed_evaluate, recording_save
        try:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            best = api.train_model("enhanced_unet", data_dir=data_dir, checkpoint_dir=ckpt_dir,
                                   max_size=ENTRY_MAX_SIZE, cfg=cfg, log=logs.append)
            first_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
        finally:
            Evaluator.evaluate, api.save_checkpoint = real_evaluate, real_save
        last = os.path.join(os.path.dirname(best), "last_model")
        with open(os.path.join(last, "meta.json")) as f:
            history = json.load(f)["history"]
        gate_launches = gates[0][1] if gates else {}
        print(f"[{card}] train_model enhanced_unet b5/b4 bf16, 3 epochs of {ENTRY_STEPS} steps "
              f"(batch 2, pad {ENTRY_MAX_SIZE}^2), gate after epoch 3: {first_s:.1f} s; losses "
              f"{history['train_loss']}; epoch s {history['epoch_time_sec']}; images/s "
              f"{history['images_per_sec']}; val mIoU {history['val_miou']}; gate wall ms "
              f"{[round(g[0], 1) for g in gates]}, launches {json.dumps(gate_launches)}; "
              f"peak memory {peak} bytes; log {logs}")
        check(os.path.exists(os.path.join(best, "state.pt"))
              and os.path.exists(os.path.join(last, "state.pt")),
              "best_model and last_model written")
        check(len(history["train_loss"]) == 3 and all(math.isfinite(v)
                                                      for v in history["train_loss"]),
              "three finite epoch losses")
        check(len(history["val_miou"]) == 1 and len(gates) == 1, "one gate, after epoch 3")
        check(gate_launches.get("mbconv_nhwc_pass1", 0) > 0
              and gate_launches.get("mbconv_nhwc_pass2", 0) > 0, "the gate launched K1")
        check(gate_launches.get("conv3x3_bn_act_wgmma", 0)
              + gate_launches.get("conv3x3_bn_act_smallc", 0) > 0, "the gate launched K2")
        check(saved.get("step") == 3 * ENTRY_STEPS, f"the saved step {saved.get('step')}")

        # resume with a budget of 4: epoch 4 only, from the saved state
        api.load_checkpoint = recording_load
        logs.clear()
        try:
            api.train_model("enhanced_unet", data_dir=data_dir, checkpoint_dir=ckpt_dir,
                            max_size=ENTRY_MAX_SIZE, cfg=dataclasses.replace(cfg, num_epochs=4),
                            resume=True, log=logs.append)
        finally:
            api.load_checkpoint = real_load
        with open(os.path.join(last, "meta.json")) as f:
            meta = json.load(f)
        step_after = torch.load(os.path.join(last, "state.pt"), map_location="cpu",
                                weights_only=True)["step"]
        print(f"[{card}] resume: restored step {restored.get('step')} at epoch "
              f"{restored.get('epoch')}, parameters/mu/nu bitwise "
              f"{restored.get('model')}/{restored.get('mu')}/{restored.get('nu')}; log {logs}; "
              f"epoch {meta['epoch']}, step {step_after}")
        check(restored.get("step") == 3 * ENTRY_STEPS and restored.get("epoch") == 3,
              "resume restored the step count and the epoch")
        check(restored.get("model") and restored.get("mu") and restored.get("nu"),
              "the restored parameters and AdamW moments equal the saved ones bitwise")
        check([line for line in logs if line.startswith("Epoch")] == [logs[1]]
              and logs[1].startswith("Epoch 4/4"), "the resumed run trains epoch 4 only")
        check(meta["epoch"] == 4 and meta["history"]["train_loss"][:3] == history["train_loss"]
              and step_after == 4 * ENTRY_STEPS, "the resumed run continues the history")
        del saved

        # the device pipeline: one 2 x 640^2 batch, card against the CPU
        items = [train_ds[0], train_ds[1]]
        pad = ((0, ENTRY_MAX_SIZE - snapped[0]), (0, ENTRY_MAX_SIZE - snapped[1]))
        cpu_in = (torch.from_numpy(np.stack([np.pad(it["image_u8"], pad + ((0, 0),))
                                             for it in items])).float(),
                  *(torch.from_numpy(np.stack([np.pad(_class_union(it, c), pad)
                                               for it in items])) for c in (0, 1)),
                  torch.from_numpy(np.stack([np.pad(it["semantic_mask"], pad)
                                             for it in items])).long())
        card_in = [t.to(dev) for t in cpu_in]
        params = augment_params(torch.Generator().manual_seed(5), 2, ENTRY_MAX_SIZE,
                                ENTRY_MAX_SIZE, "cpu")
        card_params = {k: v.to(dev) for k, v in params.items()}
        pre_cpu = cell_specific_preprocess(*cpu_in[:3])
        pre_card = cell_specific_preprocess(*card_in[:3])
        aug_cpu, masks_cpu = apply_augment(pre_cpu, cpu_in[3], params)
        aug_card, masks_card = apply_augment(pre_cpu.to(dev), card_in[3], card_params)
        full_card, full_masks = apply_augment(pre_card, card_in[3], card_params)

        def levels(card_t, cpu_t):
            d = (card_t.cpu() - cpu_t).abs()
            return d.max().item(), (d == 0).float().mean().item()

        pre_max, pre_eq = levels(pre_card, pre_cpu)
        aug_max, aug_eq = levels(aug_card, aug_cpu)
        full_max, full_eq = levels(full_card, aug_cpu)
        pipe_ms = device_ms(lambda: apply_augment(cell_specific_preprocess(*card_in[:3]),
                                                  card_in[3], card_params), 5)
        pipe_wall = device_ms(lambda: apply_augment(cell_specific_preprocess(*card_in[:3]),
                                                    card_in[3], card_params), 5, held=False)
        print(f"[{card}] device pipeline, 2 x {ENTRY_MAX_SIZE}^2: preprocess card vs cpu max "
              f"{pre_max} levels, {pre_eq:.6f} equal (tol: 16 levels, 0.9 equal); augmentation "
              f"on the same input max {aug_max}, {aug_eq:.6f} equal (tol: 3, 0.99); both "
              f"max {full_max}, {full_eq:.6f} equal; masks equal "
              f"{torch.equal(masks_card.cpu(), masks_cpu)}; preprocess + augment {pipe_ms:.3f} "
              f"ms device, {pipe_wall:.3f} ms with the host's launches (events)")
        check(torch.equal(masks_card.cpu(), masks_cpu) and torch.equal(full_masks.cpu(),
                                                                      masks_cpu),
              "the card's augmented masks equal the CPU's")
        check(pre_max <= 16 and pre_eq >= 0.9, "the card's preprocess within the CPU tests' "
              "bounds (JAX's jitted run is 11 levels and 91% equal from its op-by-op run)")
        check(aug_max <= 3 and aug_eq >= 0.99, "the card's augmentation within 3 levels, "
              "0.99 equal")
        del pre_cpu, aug_cpu, cpu_in

        # the step with and without the producer thread, whole epochs
        state = [api._build_state("enhanced_unet", cfg, ENTRY_STEPS, torch.bfloat16, dev)]
        step = make_train_step(cfg)
        gen = torch.Generator(device=dev).manual_seed(1)
        loaders = {p: BatchLoader(train_ds, 2, (ENTRY_MAX_SIZE, ENTRY_MAX_SIZE), train=True,
                                  prefetch=p, device=dev) for p in (2, 0)}

        def epoch(loader):
            torch.cuda.synchronize()
            t0, n = time.perf_counter(), 0
            for batch in loader:
                state[0], _ = step(state[0], batch["images"], batch["semantic_masks"],
                                   batch["valid_mask"], gen)
                n += 1
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0) / n

        epoch(loaders[2])
        step_ms = {2: [], 0: []}
        for p in (2, 0, 0, 2):
            step_ms[p].append(epoch(loaders[p]))
        print(f"[{card}] train step wall ms (whole epochs of {ENTRY_STEPS}, after a warm "
              f"epoch): prefetch=2 {[round(v, 1) for v in step_ms[2]]}, prefetch=0 "
              f"{[round(v, 1) for v in step_ms[0]]}")
        profile_run(lambda: epoch(loaders[2]), ENTRY_STEPS * min(step_ms[2]),
                    f"one train epoch ({ENTRY_STEPS} steps, prefetch=2) on {card}",
                    TRAIN_GROUPS)
        del state, loaders
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    import argparse

    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description="Drive the port on one CUDA card.")
    parser.add_argument("--k2-json", default=None,
                        help="also write K2's rows at every serving shape to this file")
    k2_json = parser.parse_args(argv).k2_json

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from enhanced_unet_tpu_torch.benchmarks import dw_variants, mbconv_instr
    from enhanced_unet_tpu_torch.benchmarks import mbconv_proto as proto
    from enhanced_unet_tpu_torch.benchmarks.microtime import device_ms
    from enhanced_unet_tpu_torch.models import blocks, encoders
    from enhanced_unet_tpu_torch.ops.kernels import KERNEL_SOURCES, build
    from enhanced_unet_tpu_torch.ops.kernels import conv_fused, depthwise, mbconv
    from enhanced_unet_tpu_torch.ops.kernels import copy as copy_k
    from enhanced_unet_tpu_torch.train.evaluator import Evaluator
    import torch.nn.functional as F

    dev = torch.device("cuda")
    # ---- 1. the card -----------------------------------------------------
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    secs = build.build_all(KERNEL_SOURCES)
    for name in KERNEL_SOURCES:
        build.load(name)
    print(f"build: {json.dumps({k: round(v, 2) for k, v in secs.items()})} "
          f"total {time.perf_counter() - t0:.2f} s")

    # ---- 3. kernels against their plain versions -------------------------
    g = torch.Generator(device=dev).manual_seed(0)
    results = {}

    def conv_case(n, h, w, cin, cout, dtype, relu=True):
        x = torch.randn(n, h, w, cin, generator=g, device=dev).to(dtype)
        wt = torch.randn(3, 3, cin, cout, generator=g, device=dev) / (9 * cin) ** 0.5
        sc = torch.rand(cout, generator=g, device=dev) + 0.5
        sh = torch.randn(cout, generator=g, device=dev) * 0.1
        return x, wt, sc, sh, relu

    def conv_library(x, wt, sc, sh, relu):
        # cuDNN conv + epilogue in torch: a yardstick the port never calls
        y = F.conv2d(x.permute(0, 3, 1, 2), wt.to(x.dtype).permute(3, 2, 0, 1),
                     padding=1)
        y = y.float() * sc[None, :, None, None] + sh[None, :, None, None]
        return torch.relu(y).to(x.dtype) if relu else y.to(x.dtype)

    def conv_bound(n, h, w, cin, cout):
        # x read and the output written once, the bf16 weights and the fp32
        # scale/shift once; 2 * 9 * Cin * Cout FLOPs per output pixel
        return bound(n * h * w * (cin + cout) * 2 + 9 * cin * cout * 2 + cout * 8,
                     2 * 9 * cin * cout * n * h * w, "bf16")

    def k2_row(shape, relu=True, iters=K2_ITERS):
        """K2 at one bf16 shape through the packed entry point: checked
        against its plain version (2e-2 of max |value|), then timed beside
        the plain version, cuDNN + a torch epilogue (`library_ms`),
        cuDNN's channels_last bf16 conv alone (`library_conv_ms`) and the
        `mma.sync` kernel on the same packed weights (`mma_ms`); a wgmma
        row also gives its tile and the bytes its tiles read from L2."""
        n, h, w, cin, cout = shape
        x, wt, sc, sh, relu = args = conv_case(n, h, w, cin, cout, torch.bfloat16, relu)
        packed = conv_fused.pack_conv3x3(wt, sc, sh, x.dtype, dev)
        got = conv_fused.fused_conv3x3_bn_relu_packed(x, packed, relu)
        torch.cuda.synchronize()
        want = conv_fused.fused_conv3x3_bn_relu_plain(*args)
        err = (got.float() - want.float()).abs().max().item()
        rel = err / want.float().abs().max().item()
        check(rel <= 2e-2, f"conv3x3_bn_act bf16 {shape} rel err {rel}")
        del got, want
        xl = x.permute(0, 3, 1, 2)                    # NCHW view, channels_last
        wl = wt.to(x.dtype).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        b, kind = conv_bound(*shape)
        kernel = lambda: conv_fused.fused_conv3x3_bn_relu_packed(x, packed, relu)  # noqa: E731
        tile = l2_read = None
        if packed.variant == "wgmma":
            # what the tiles read from L2: per tile and chunk one haloed
            # input box and nine weight stages (TMA boxes, out-of-range
            # parts included)
            bn, mt, kc = conv_fused.wgmma_tile(*shape)
            tiles = -(-w // 16) * -(-h // (8 * mt)) * -(-cout // bn) * n
            l2_read = tiles * -(-cin // kc) * ((8 * mt + 2) * 18 * kc * 2 + 9 * bn * kc * 2)
            tile = f"{8 * mt * 16} px x {bn} ch, {kc}-ch chunks"
        return dict(
            shape=f"[{n},{h},{w},{cin}]->{cout} bf16", variant=packed.variant,
            tile=tile, l2_read_bytes=l2_read,
            max_abs_err=err, rel_err=rel, ms=device_ms(kernel, iters),
            wall_ms=device_ms(kernel, iters, held=False),
            plain_ms=device_ms(lambda: conv_fused.fused_conv3x3_bn_relu_plain(*args), iters),
            bound_ms=b, bound_by=kind,
            library_ms=device_ms(lambda: conv_library(*args), iters),
            library_conv_ms=device_ms(lambda: F.conv2d(xl, wl, padding=1), iters),
            mma_ms=device_ms(lambda: conv_fused.launch("mma", x, packed, relu), iters)
            if packed.variant != "mma" else None)

    def print_k2(r):
        mma = "" if r["mma_ms"] is None else f", mma.sync kernel {r['mma_ms']:.4f} ms"
        if r["tile"]:
            mma += f"; tile {r['tile']}, {r['l2_read_bytes'] / 1e6:.1f} MB read from L2"
        print(f"K2 {r['variant']} {r['shape']}: rel err {r['rel_err']:.3e} (tol 2e-2); "
              f"kernel {r['ms']:.4f} ms (unheld {r['wall_ms']:.4f}){mma}, plain "
              f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f} (conv alone "
              f"{r['library_conv_ms']:.4f}), bound {r['bound_ms']:.4f} ({r['bound_by']})")

    k2_shapes = [  # (n, h, w, cin, cout): TTA trio of a 2-image 512^2 request
        (6, 512, 512, 6, 256), (6, 512, 512, 256, 128), (6, 512, 512, 128, 64),
        (6, 256, 256, 256, 32),      # UNet++ x_0_3 conv1 (B5: 64 + 4*48 -> 32)
    ]
    for shape in k2_shapes:          # fp32 (CUDA cores, TF32 off for the plain version)
        args = conv_case(*shape, torch.float32)
        got = conv_fused.fused_conv3x3_bn_relu(*args)
        torch.cuda.synchronize()
        want = conv_fused.fused_conv3x3_bn_relu_plain(*args)
        err = (got.float() - want.float()).abs().max().item()
        rel = err / want.float().abs().max().item()
        print(f"K2 conv3x3_bn_act f32 {shape}: max_abs_err {err:.3e} rel {rel:.3e} (tol 1e-4)")
        check(rel <= 1e-4, f"conv3x3_bn_act f32 {shape} rel err {rel}")
        del got, want, args
    for shape in k2_shapes:
        r = k2_row(shape)
        print_k2(r)
        results.setdefault(f"conv3x3_bn_act_{r['variant']}", r)
    # the general bf16 path (shapes neither wgmma nor smallc takes): one call
    # of the public entry with the counts at 0, then its row
    general = (1, 37, 45, 70, 5)
    reset([conv_fused.LAUNCHES])
    conv_fused.fused_conv3x3_bn_relu(*conv_case(*general, torch.bfloat16, relu=False))
    general_launches = conv_fused.LAUNCHES["conv3x3_bn_act_mma"]
    check(general_launches == 1, f"the general path launched {conv_fused.LAUNCHES}")
    r = k2_row(general, relu=False)
    print_k2(r)
    results["conv3x3_bn_act_mma"] = r

    def mbconv_case(n, cin, ratio, cout, h, w, dtype):
        """A seeded fused block's folded weights and a channels_last input,
        as the serving path hands K1 its stage-0 tensors."""
        from enhanced_unet_tpu_torch.models import init_random_weights_
        from enhanced_unet_tpu_torch.models.encoders import MBConvBlock

        blk = MBConvBlock(cin, cout, ratio, 1, 3, fused=True, dtype=dtype)
        init_random_weights_(blk, 1).eval().to(dev)
        x = torch.randn(n, h, w, cin, generator=g, device=dev).to(dtype).permute(0, 3, 1, 2)
        return x, blk.fold(), blk.residual

    def k1_rows(x, p, res, iters=K1_ITERS):
        """K1's two passes at one shape on the kernels `variant_for` picks
        (the `nhwc` and `nhwc_expand` ones read x's channels_last memory, the
        `nchw` ones an NCHW copy): pass 1's sums checked within 1e-3 and pass
        2's output within 2e-2 (bf16) or 1e-4 (fp32) of max |value| of the
        plain version (pass 2 from the plain sums' gated weights), then timed
        beside the plain version and, for `nhwc` and `nhwc_expand`, the
        `nchw` kernels on an NCHW copy of the same values (`nchw_ms`), the
        kernel forced to 8- and to 16-row tiles (`rows_ms`; `ms` is at the
        rows `nhwc_tile_rows` picks) and the library's channels_last block,
        several PyTorch calls for both passes and the gate
        (`library_block_ms`, on both rows)."""
        n, cin, h, w = x.shape
        mid, cout = p.wdw.shape[0], p.wproj.shape[1]
        expand = p.wexp is not None
        variant = mbconv.variant_for(x, p)
        xc = x.contiguous()
        if variant == "nhwc":
            pass1, pass2 = mbconv.mbconv_nhwc_pass1, mbconv.mbconv_nhwc_pass2
        elif variant == "nhwc_expand":
            pass1, pass2 = mbconv.mbconv_nhwc_expand_pass1, mbconv.mbconv_nhwc_expand_pass2
        else:
            x, pass1, pass2 = xc, mbconv.mbconv_pass1, mbconv.mbconv_pass2
        if variant != "nchw":
            check(x.is_contiguous(memory_format=torch.channels_last), "a channels_last input")
        sums = pass1(x, p)
        want1 = mbconv.mbconv_pass1_plain(x, p)
        err1 = (sums - want1).abs().max().item()
        rel1 = err1 / want1.abs().max().item()
        check(rel1 <= 1e-3, f"K1 {variant} pass 1 {tuple(x.shape)} sums rel err {rel1}")
        wpp = mbconv.se_gated_projection(want1, p, h * w, x.dtype)
        got = pass2(x, p, wpp, res)
        torch.cuda.synchronize()
        want = mbconv.mbconv_pass2_plain(x, p, wpp, res)
        err2 = (got.float() - want.float()).abs().max().item()
        rel2 = err2 / want.float().abs().max().item()
        tol2 = 2e-2 if x.dtype == torch.bfloat16 else 1e-4
        check(rel2 <= tol2, f"K1 {variant} pass 2 {tuple(x.shape)} rel err {rel2}")
        del sums, got, want
        # per pixel: expand 2*cin*mid (+ bias, SiLU ~5*mid), depthwise
        # 18*mid (+ bias, SiLU ~5*mid); pass 1 adds the sum (mid), pass 2
        # the projection 2*mid*cout (+ bias, residual 2*cout); values of x's
        # element size, bf16 on the tensor cores' peak, fp32 on the CUDA
        # cores'
        hw, es = n * h * w, x.element_size()
        kind = "bf16" if x.dtype == torch.bfloat16 else "fp32"
        ops = (2 * cin + 5) * mid * expand + 23 * mid
        w_bytes = (mid * cin * es + mid * 4) * expand + mid * (9 * es + 4)
        b1, by1 = bound(hw * cin * es + w_bytes + n * mid * 4, hw * (ops + mid), kind)
        b2, by2 = bound(hw * (cin + cout) * es + w_bytes + n * mid * cout * es + cout * 4,
                        hw * (ops + 2 * mid * cout + 2 * cout), kind)
        nhwc = variant != "nchw"
        # the library's channels_last block on the same values (a view of
        # x for `nhwc` and `nhwc_expand`, a channels_last copy for `nchw`)
        xh, lp = x.permute(0, 2, 3, 1).contiguous(), p._asdict()
        library = device_ms(lambda: proto.mbconv_nhwc_library(
            xh, lp, expand=expand, residual=res), iters)

        def at_rows(th, kernel):
            # the kernel's time with `nhwc_tile_rows` answering `th`
            pick, mbconv.nhwc_tile_rows = mbconv.nhwc_tile_rows, lambda *a: th
            try:
                return device_ms(kernel, iters)
            finally:
                mbconv.nhwc_tile_rows = pick

        def row(shape, err, rel, kernel, plain, nchw_kernel, b, by):
            return dict(
                shape=shape, variant=variant, max_abs_err=err, rel_err=rel,
                ms=device_ms(kernel, iters), wall_ms=device_ms(kernel, iters, held=False),
                plain_ms=device_ms(plain, iters),
                nchw_ms=device_ms(nchw_kernel, iters) if nhwc else None,
                rows_ms={th: at_rows(th, kernel) for th in (8, 16)} if nhwc else None,
                bound_ms=b, bound_by=by, library_ms=None, library_block_ms=library)

        what = f"[{n},{cin},{h},{w}] mid {mid}"
        r1 = row(f"{what} {kind}", err1, rel1, lambda: pass1(x, p),
                 lambda: mbconv.mbconv_pass1_plain(x, p),
                 lambda: mbconv.mbconv_pass1(xc, p), b1, by1)
        r2 = row(f"{what} ->{cout}{' residual' if res else ''} {kind}", err2, rel2,
                 lambda: pass2(x, p, wpp, res),
                 lambda: mbconv.mbconv_pass2_plain(x, p, wpp, res),
                 lambda: mbconv.mbconv_pass2(xc, p, wpp, res), b2, by2)
        return r1, r2

    def print_k1(r, what):
        nchw = "" if r["nchw_ms"] is None else (
            f" (8-row tiles {r['rows_ms'][8]:.4f}, 16-row {r['rows_ms'][16]:.4f}), "
            f"nchw kernel {r['nchw_ms']:.4f}")
        lib = ("" if r["library_block_ms"] is None else
               f", library block (both passes, several calls) {r['library_block_ms']:.4f}")
        print(f"K1 {r['variant']} {what} {r['shape']}: rel err {r['rel_err']:.3e}; kernel "
              f"{r['ms']:.4f} ms (unheld {r['wall_ms']:.4f}){nchw}, plain {r['plain_ms']:.4f}"
              f"{lib}, bound {r['bound_ms']:.4f} ({r['bound_by']})")

    bf16, fp32 = torch.bfloat16, torch.float32
    k1_shapes = {  # stage-0 blocks at 256^2 (512^2 input), TTA trio batch 6
        (6, 48, 1, 24, 256, 256, bf16): "nhwc", (6, 24, 1, 24, 256, 256, bf16): "nhwc",
        (6, 40, 6, 40, 128, 128, bf16): "nhwc_expand",  # a stride-1 block of B5 stage 1
        (6, 40, 6, 40, 128, 128, fp32): "nchw",         # the same block in fp32
        # stage 0's blocks in fp32 (a model with compute_dtype float32)
        (6, 48, 1, 24, 256, 256, fp32): "nchw", (6, 24, 1, 24, 256, 256, fp32): "nchw",
        # a stage-3 and a stage-6 block of B5 in bf16 (wider than 64 channels)
        (6, 128, 6, 128, 32, 32, bf16): "nchw", (6, 512, 6, 512, 16, 16, bf16): "nchw",
    }
    # the `nhwc_expand` and `nchw` kernels' entries report this phase's bf16
    # expand block and first fp32 block: their launches are counted over that
    # case alone (every case also launches the `nchw` kernels beside its own,
    # and phase 3b's B1 and B2 runs have entries of their own)
    case_launches = {}
    with torch.no_grad():
        for shape, expected in k1_shapes.items():
            x, p, res = mbconv_case(*shape)
            variant = mbconv.variant_for(x, p)
            check(variant == expected, f"K1 {shape} -> {variant}")
            reset([mbconv.LAUNCHES])
            got = mbconv.mbconv_infer_nchw(x, p, residual=res)     # the entry
            torch.cuda.synchronize()
            want = mbconv.mbconv_infer_nchw_plain(x, p, residual=res)
            err = (got.float() - want.float()).abs().max().item()
            rel = err / want.float().abs().max().item()
            tol = 2e-2 if x.dtype == bf16 else 1e-4
            print(f"K1 mbconv {shape} residual={res} ({variant}): max_abs_err "
                  f"{err:.3e} rel {rel:.3e} (tol {tol:g})")
            check(rel <= tol, f"mbconv {shape} rel err {rel}")
            del got, want
            r1, r2 = k1_rows(x, p, res)
            print_k1(r1, "pass 1")
            print_k1(r2, "pass 2")
            prefix = "mbconv_" if variant == "nchw" else f"mbconv_{variant}_"
            results.setdefault(prefix + "pass1", r1)
            results.setdefault(prefix + "pass2", r2)
            case_launches.setdefault(variant, dict(mbconv.LAUNCHES))
            del x, p
    for variant in ("nhwc_expand", "nchw"):
        prefix = "mbconv_" if variant == "nchw" else f"mbconv_{variant}_"
        check(min(case_launches[variant][prefix + k] for k in ("pass1", "pass2")) > 0,
              f"the {variant} case launched {case_launches[variant]}")

    # ---- 3b. the kernel benches -------------------------------------------
    # each bench checks its kernels against their plain versions and times
    # them (`microtime.kernel_row`); their rows make the kernels' entries
    counters = (conv_fused.LAUNCHES, mbconv.LAUNCHES, depthwise.LAUNCHES,
                copy_k.LAUNCHES)
    t0 = time.perf_counter()
    reset(counters)
    with torch.no_grad():
        rows = dw_variants.main() + mbconv_instr.main()
        bench_mbconv = dict(mbconv.LAUNCHES)          # B2's passes and its full block
        stages = []                                   # B1's cases, counted one by one
        for case in proto.CASES:
            before = dict(mbconv.LAUNCHES)
            rows.append(proto.run_case(*case, device=dev))
            stages.append({k: v - before[k] for k, v in mbconv.LAUNCHES.items()
                           if v != before[k]})
    check(set(stages[0]) == {"mbconv_nhwc_pass1", "mbconv_nhwc_pass2"}
          and set(stages[1]) == {"mbconv_nhwc_expand_pass1", "mbconv_nhwc_expand_pass2"},
          f"B1 stage 0 reaches the nhwc kernels and stage 1 the nhwc_expand ones: {stages}")
    check(min(bench_mbconv["mbconv_pass1"], bench_mbconv["mbconv_pass2"]) > 0,
          f"B2's passes reach the nchw kernels: {bench_mbconv}")
    # B1's entry reports stage 0 (`results` keeps the first case's row)
    bench_launches = {**depthwise.LAUNCHES, **copy_k.LAUNCHES,
                      "mbconv_proto": sum(stages[0].values()),
                      "mbconv_pass1_b2": bench_mbconv["mbconv_pass1"],
                      "mbconv_pass2_b2": bench_mbconv["mbconv_pass2"]}
    print(f"benches: {time.perf_counter() - t0:.2f} s, launches "
          f"{json.dumps(bench_launches)}, mbconv {json.dumps(mbconv.LAUNCHES)}")
    for name, count in {**bench_launches, **mbconv.LAUNCHES}.items():
        check(count > 0, f"kernel {name} was not launched by the benches")
    rows = {r["bench"]: r for r in rows if "bench" in r}

    n, c, h, w = mbconv_instr.N, mbconv_instr.C, mbconv_instr.H, mbconv_instr.W
    check((n, c, h, w) == (dw_variants.N, dw_variants.C, dw_variants.H, dw_variants.W),
          "the depthwise benches share one shape")
    elems = n * c * h * w
    # read x once, write the output once (+ weights); 9 multiply-adds, the
    # bias and the SiLU (~5) per element
    dw_bound = bound(elems * 4 + c * (9 * 2 + 4), elems * 23, "bf16")
    shape = f"[{n},{c},{h},{w}] bf16"
    # B2's passes on the `nchw` kernels (mid = C, no expand): pass 1 reads
    # x once and writes the sums, pass 2 reads x and writes the output (+
    # the weights, the per-image gated projection); per element the
    # depthwise with bias and SiLU (23) and the sum (1), or the projection
    # (2*C) with bias and residual (2)
    w_dw = c * (9 * 2 + 4)
    pass_bounds = (bound(elems * 2 + w_dw + n * c * 4, elems * 24, "bf16"),
                   bound(elems * 4 + w_dw + n * c * c * 2 + c * 4,
                         elems * (23 + 2 * c + 2), "bf16"))
    entries = [("dw3x3_bias_silu", rows["dw3x3_bias_silu"], shape, dw_bound, 2e-2),
               ("dw_rows_silu", rows["dw_only"], f"{shape} bh {mbconv_instr.BH}",
                dw_bound, 2e-2),
               ("copy", rows["copy"], shape, bound(elems * 4, 0, "bf16"), 0.0),
               ("mbconv_pass1_b2", rows["pass1"], f"B2 pass 1 {shape} mid {c} (sums)",
                pass_bounds[0], mbconv_instr.SUMS_TOL),
               ("mbconv_pass2_b2", rows["pass2"], f"B2 pass 2 {shape} mid {c} ->{c} residual",
                pass_bounds[1], mbconv_instr.BF16_TOL)]
    for name, bn, cin, mid, cout, bh, bw, expand in proto.CASES:
        hw = bn * bh * bw
        # the block once: x read and the output written once (+ weights);
        # per pixel the expand (2*cin*mid, bias and SiLU ~5*mid), the
        # depthwise with bias and SiLU (23*mid) and its pool sum (mid), the
        # projection (2*mid*cout) with bias and residual (2*cout)
        ops = hw * ((2 * cin + 5) * mid * expand + 24 * mid + 2 * mid * cout + 2 * cout)
        w_bytes = ((mid * cin * 2 + mid * 4) * expand + mid * (9 * 2 + 4)
                   + mid * cout * 4 + cout * 4)
        entries.append(("mbconv_proto", rows[name],
                        f"{name} [{bn},{cin},{bh},{bw}] mid {mid} residual bf16",
                        bound(hw * (cin + cout) * 2 + w_bytes, ops, "bf16"), 2e-2))
    copy_ms = rows["copy"]["ms"]
    for key, row, what, (b, kind), tol in entries:
        # a depthwise kernel's held time over the copy kernel's, same run:
        # what the card really gives for the same bytes
        ratio = {"copy_ratio": row["ms"] / copy_ms} if key.startswith("dw") else {}
        print(f"{key} {what}: max_abs_err {row['max_abs_err']:.3e} rel "
              f"{row['rel_err']:.3e} (tol {tol:g}); kernel {row['ms']:.4f} ms (unheld "
              f"{row['wall_ms']:.4f}), plain {row['plain_ms']:.4f} ms, library "
              f"{'none' if row['library_ms'] is None else format(row['library_ms'], '.4f')}"
              + (f" (yardstick: grouped 3x1 conv + bias + SiLU {row['yardstick_ms']:.4f})"
                 if "yardstick_ms" in row else "") + f", bound {b:.4f} ms ({kind})"
              + (f", copy_ratio {ratio['copy_ratio']:.3f} (copy kernel {copy_ms:.4f} ms)"
                 if ratio else ""))
        check(row["rel_err"] <= tol, f"{key} {what} rel err {row['rel_err']}")
        # the MBConv block's library yardstick is several calls: no library_ms
        results.setdefault(key, dict(
            shape=what, max_abs_err=row["max_abs_err"], ms=row["ms"],
            wall_ms=row["wall_ms"], plain_ms=row["plain_ms"], bound_ms=b, bound_by=kind,
            library_ms=None if key == "mbconv_proto" else row["library_ms"],
            **ratio, **{k: row[k] for k in ("yardstick_ms",) if k in row}))
    # B2's passes beside the library's channels_last block (several calls,
    # both passes and the gate) on the bench's values: its seeded parameters
    # and input, drawn again in the same order
    gb = torch.Generator(device=dev).manual_seed(0)
    pb = proto.make_params(gb, c, c, c, 6)
    b2_dims = (mbconv_instr.N, mbconv_instr.C, mbconv_instr.H, mbconv_instr.W)
    xb = (torch.randn(b2_dims, generator=gb, device=dev) * 0.5).to(proto.DT)
    check(b2_dims == (n, c, h, w), f"B2's library block at the bench's shape: {b2_dims}")
    xbh = xb.permute(0, 2, 3, 1).contiguous()
    b2_block = device_ms(lambda: proto.mbconv_nhwc_library(xbh, pb, expand=False,
                                                            residual=True), K1_ITERS)
    for key in ("mbconv_pass1_b2", "mbconv_pass2_b2"):
        results[key]["library_block_ms"] = b2_block
    print(f"B2 passes {list(xb.shape)} bf16 mid {c}: library block (both passes and the "
          f"gate, several calls) {b2_block:.4f} ms")
    del xb, xbh
    # dw3x3 with bf16 weights, as the TPU script hands its kernels: the
    # bench's call (fp32 weights) also runs the wrapper's cast, one more
    # small kernel a call
    dims = (dw_variants.N, dw_variants.C, dw_variants.H, dw_variants.W)
    xb = torch.randn(dims, generator=g, device=dev).to(torch.bfloat16)
    w32, b32 = (torch.randn(dims[1], 3, 3, generator=g, device=dev) * 0.1,
                torch.randn(dims[1], generator=g, device=dev) * 0.1)
    w16 = w32.to(torch.bfloat16)
    results["dw3x3_bias_silu"]["bf16_weights_ms"] = device_ms(
        lambda: depthwise.dw3x3_bias_silu(xb, w16, b32), 30)
    print(f"dw3x3_bias_silu {list(dims)} with bf16 weights (no cast): "
          f"{results['dw3x3_bias_silu']['bf16_weights_ms']:.4f} ms")
    # the 2-byte path (W not a multiple of 8; a start 6 bytes into its
    # storage) and W > 256 (runs that end mid-row), held against the plain
    # versions; these launches come after the counts were read
    for dims, offset, what, bh in (((2, 24, 33, 45), 0, "W not a multiple of 8", 11),
                                   ((2, 3, 40, 256), 3, "a start 6 bytes in", 8),
                                   ((1, 4, 64, 520), 0, "runs ending mid-row", 32)):
        flat = torch.randn(math.prod(dims) + offset, generator=g, device=dev)
        xs = flat.to(torch.bfloat16)[offset:].view(dims)
        wc, bc = w32[:dims[1]], b32[:dims[1]]
        for key, got, want in (
                ("dw3x3_bias_silu", depthwise.dw3x3_bias_silu(xs, wc, bc),
                 depthwise.dw3x3_bias_silu_plain(xs, wc, bc)),
                (f"dw_rows_silu bh {bh}", depthwise.dw_rows_silu(xs, wc, bc, bh),
                 depthwise.dw_rows_silu_plain(xs, wc, bc, bh))):
            torch.cuda.synchronize()
            rel = ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
            print(f"{key} {list(dims)} starting {offset} elements in ({what}): "
                  f"rel err {rel:.3e} (tol 2e-2)")
            check(rel <= 2e-2, f"{key} {dims} +{offset} rel err {rel}")
    cr = rows["copy"]
    print(f"copy bandwidth {shape}: kernel {cr['gb_per_s']:.1f} GB/s, Tensor.copy_ "
          f"{cr['library_gb_per_s']:.1f} GB/s measured; data sheet "
          f"{HBM_BYTES_PER_S / 1e9:.0f} GB/s (the bounds' divisor)")

    # ---- 4. the slice: full-width flagship served with TTA ---------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = serving_model()                   # device None: the card
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: enhanced_unet b5/b4 bf16, {n_params} parameters, built in "
          f"{time.perf_counter() - t0:.2f} s")
    evaluator = Evaluator(model, "enhanced_unet")
    check(evaluator.enable_tta, "the enhanced_unet preset serves with TTA")
    requests = [synthetic_images(2, 512, seed) for seed in range(3)]
    # the first (cold) request records every shape K2 is called at; every
    # request counts its weight packs (ConvBNAct packs once, then reuses)
    k2_calls, packs = {}, []
    packed_entry, pack = blocks.fused_conv3x3_bn_relu_packed, blocks.pack_conv3x3

    def recording_entry(x, packed, relu=True):
        key = (tuple(x.shape) + (packed.cout,), relu)
        k2_calls[key] = k2_calls.get(key, 0) + 1
        return packed_entry(x, packed, relu)

    def counting_pack(*args):
        packs[-1] += 1
        return pack(*args)

    # K1 likewise: the first request records each (input shape, Cout,
    # residual) with one block's folded weights, and whether every input
    # came channels_last and every folded weight sat on the card in its
    # kernel dtype (so the wrapper copies nothing); every request counts
    # its folds (MBConvBlock folds once, then reuses)
    k1_calls, folds, k1_inputs = {}, [], set()
    k1_entry, fold = encoders.mbconv_infer_nchw, encoders.fold_mbconv_weights

    def recording_k1(x, p, residual):
        key = (tuple(x.shape), p.wproj.shape[1], residual)
        k1_calls.setdefault(key, [0, p])[0] += 1
        k1_inputs.add((x.is_contiguous(memory_format=torch.channels_last),
                       p.wdw.dtype == x.dtype and all(
                           t.device == x.device and t.is_contiguous()
                           for t in (p.wdw, p.bdw, p.bproj))))
        return k1_entry(x, p, residual=residual)

    def counting_fold(*args, **kwargs):
        folds[-1] += 1
        return fold(*args, **kwargs)

    blocks.pack_conv3x3 = counting_pack
    encoders.fold_mbconv_weights = counting_fold
    torch.cuda.reset_peak_memory_stats()
    reset(counters)
    times = []
    classes_seen = set()
    for i, imgs in enumerate(requests):
        blocks.fused_conv3x3_bn_relu_packed = recording_entry if i == 0 else packed_entry
        encoders.mbconv_infer_nchw = recording_k1 if i == 0 else k1_entry
        packs.append(0)
        folds.append(0)
        t0 = time.perf_counter()
        masks = evaluator.predict_semantic_masks(imgs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check(masks.shape == (2, 512, 512), f"mask shape {masks.shape}")
        check(masks.dtype.kind == "i", f"mask dtype {masks.dtype}")
        counts = [int((masks == c).sum()) for c in range(3)]
        check(sum(counts) == masks.size, "mask values outside {0, 1, 2}")
        classes_seen |= {c for c in range(3) if counts[c]}
        print(f"request: 2x512^2 TTA, {times[-1] * 1e3:.1f} ms, classes {counts}")
    blocks.pack_conv3x3 = pack
    encoders.mbconv_infer_nchw, encoders.fold_mbconv_weights = k1_entry, fold
    launches = {**conv_fused.LAUNCHES, **mbconv.LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    print(f"slice: request ms {[round(t * 1e3, 1) for t in times]}, "
          f"peak memory {peak} bytes, launches {json.dumps(launches)}, "
          f"K2 weight packs per request {packs}, K1 weight folds per request {folds}")
    check(len(classes_seen) >= 2, f"the cascade decided only {classes_seen}")
    serving = ("conv3x3_bn_act_wgmma", "conv3x3_bn_act_smallc", "mbconv_nhwc_pass1",
               "mbconv_nhwc_pass2")
    for name in serving:
        check(launches[name] > 0, f"kernel {name} was not launched by the serving path")
    off_path = {k: v for k, v in {**launches, **depthwise.LAUNCHES,
                                  **copy_k.LAUNCHES}.items() if k not in serving}
    check(not any(off_path.values()), f"the serving path launched {off_path}")
    check(launches["mbconv_pass1"] == launches["mbconv_pass2"] == 0,
          f"the bf16 request launched no nchw kernel: {launches}")
    check(packs[0] > 0 and not any(packs[1:]), f"K2 weight packs per request {packs}")
    k1_per_request = sum(c for c, _ in k1_calls.values())
    check(launches["mbconv_nhwc_pass1"] == launches["mbconv_nhwc_pass2"]
          == k1_per_request * len(requests), "the recorded K1 calls are the serving run's")
    check(folds[0] > 0 and not any(folds[1:]), f"K1 weight folds per request {folds}")
    check(k1_inputs == {(True, True)},
          "every K1 input channels_last and every folded weight in place on the card")
    groups = profile_run(lambda: evaluator.predict_semantic_masks(requests[-1]),
                         1e3 * min(times[1:]), "one request")

    # ---- 4b. K2 at every shape the serving path gave it ------------------
    t0 = time.perf_counter()
    k2_rows = []
    for (shape, relu), count in k2_calls.items():
        r = k2_row(shape[:5], relu)
        r["launches"] = count
        print_k2(r)
        k2_rows.append(r)
    check(sum(r["launches"] for r in k2_rows) * len(requests)
          == launches["conv3x3_bn_act_wgmma"] + launches["conv3x3_bn_act_smallc"],
          "the recorded K2 calls are the serving run's")
    check(all(r["variant"] in ("wgmma", "smallc") for r in k2_rows),
          "every serving shape reaches the wgmma or the small-Cin kernel")
    per_req = {k: sum(r["launches"] * r[k] for r in k2_rows)
               for k in ("ms", "wall_ms", "bound_ms", "mma_ms", "library_ms",
                         "library_conv_ms", "plain_ms")}
    print(f"K2 per request ({len(k2_rows)} shapes, {sum(r['launches'] for r in k2_rows)} "
          f"launches; sum of launches x time): kernel {per_req['ms']:.4f} ms (unheld "
          f"{per_req['wall_ms']:.4f}), bound {per_req['bound_ms']:.4f} ms, mma.sync "
          f"kernel {per_req['mma_ms']:.4f}, cuDNN + epilogue {per_req['library_ms']:.4f}, "
          f"cuDNN conv alone {per_req['library_conv_ms']:.4f}, plain "
          f"{per_req['plain_ms']:.4f}; profiled K2 group "
          f"{groups.get('conv3x3_bn_act (K2)', float('nan')):.4f} ms; "
          f"{time.perf_counter() - t0:.1f} s")
    if k2_json:
        with open(k2_json, "w") as f:
            json.dump({"card": card, "rows": k2_rows, "per_request": per_req}, f, indent=1)

    # ---- 4c. K1 at every shape the serving path gave it ------------------
    t0 = time.perf_counter()
    k1_rows_all, k1_library = [], 0.0
    with torch.no_grad():
        for ((n, c, h, w), cout, res), (count, p) in k1_calls.items():
            x = torch.randn(n, h, w, c, generator=g, device=dev).bfloat16().permute(0, 3, 1, 2)
            check(mbconv.variant_for(x, p) == "nhwc", f"K1 serving shape {(n, c, h, w)} is nhwc")
            for r, what in zip(k1_rows(x, p, res), ("pass 1", "pass 2")):
                r["launches"] = count
                print_k1(r, what)
                k1_rows_all.append(r)
            k1_library += count * r["library_block_ms"]
            del x
    k1_req = {k: sum(r["launches"] * r[k] for r in k1_rows_all)
              for k in ("ms", "wall_ms", "bound_ms", "nchw_ms", "plain_ms")}
    print(f"K1 per request ({len(k1_calls)} shapes, {2 * k1_per_request} launches; sum of "
          f"launches x time): kernel {k1_req['ms']:.4f} ms (unheld {k1_req['wall_ms']:.4f}), "
          f"bound {k1_req['bound_ms']:.4f} ms, nchw kernels {k1_req['nchw_ms']:.4f}, plain "
          f"{k1_req['plain_ms']:.4f}, library block (several calls, both passes and the "
          f"gate) {k1_library:.4f}; profiled K1 group "
          f"{groups.get('mbconv (K1)', float('nan')):.4f} ms; {time.perf_counter() - t0:.1f} s")

    # ---- 4d. the nhwc_expand kernels at stage 1's serving shapes ---------
    # not routed (the serving path fuses stage 0 only): each stride-1 block
    # shape of B5's and B4's stage 1 in one request, checked and timed beside
    # the nchw kernels, the library block and the bound, pass by pass; and the
    # entry (pass 1, the SE gate, pass 2) beside the stock path's eval-mode
    # block on the same weights (what serving runs), like for like
    from enhanced_unet_tpu_torch.models import init_random_weights_
    from enhanced_unet_tpu_torch.models.encoders import MBConvBlock

    t0 = time.perf_counter()
    k1x_rows, k1x_req = [], {}
    with torch.no_grad():
        for (n, c, hw_), blocks_per_forward in EXPAND_SERVING.items():
            fused = init_random_weights_(MBConvBlock(c, c, 6, 1, 3, fused=True), 7)
            fused.eval().to(dev)
            stock = MBConvBlock(c, c, 6, 1, 3, fused=False).eval().to(dev)
            stock.load_state_dict(fused.state_dict())
            x = torch.randn(n, hw_, hw_, c, generator=g, device=dev).bfloat16()
            x = x.permute(0, 3, 1, 2)
            p = fused.fold()
            check(mbconv.variant_for(x, p) == "nhwc_expand", f"stage-1 shape {(n, c, hw_)}")
            r1, r2 = k1_rows(x, p, True)
            stock_ms = device_ms(lambda: stock(x), K1_ITERS)

            def entry():
                return mbconv.mbconv_infer_nchw(x, p, residual=True)

            row = {"shape": f"[{n},{c},{hw_},{hw_}] mid {6 * c} ->{c} residual bf16",
                   "blocks_per_forward": blocks_per_forward,
                   "rel_err": (r1["rel_err"], r2["rel_err"]), "stock_ms": stock_ms,
                   "entry_ms": device_ms(entry, K1_ITERS),
                   "entry_wall_ms": device_ms(entry, K1_ITERS, held=False),
                   **{k: r1[k] + r2[k] for k in ("ms", "wall_ms", "plain_ms", "nchw_ms",
                                                 "bound_ms")},
                   "rows_ms": {th: r1["rows_ms"][th] + r2["rows_ms"][th] for th in (8, 16)},
                   "library_block_ms": r1["library_block_ms"]}
            print(f"K1 nhwc_expand stage 1 {row['shape']}: rel err pass 1 {r1['rel_err']:.3e} "
                  f"(tol 1e-3), pass 2 {r2['rel_err']:.3e} (tol 2e-2); entry (passes and "
                  f"gate) {row['entry_ms']:.4f} ms (unheld {row['entry_wall_ms']:.4f}) beside "
                  f"the stock eval-mode block {stock_ms:.4f}; both passes "
                  f"{row['ms']:.4f} ms (pass 1 {r1['ms']:.4f}, pass 2 {r2['ms']:.4f}; unheld "
                  f"{row['wall_ms']:.4f}; 8-row tiles {row['rows_ms'][8]:.4f}, 16-row "
                  f"{row['rows_ms'][16]:.4f}), "
                  f"nchw kernels {row['nchw_ms']:.4f}, library block "
                  f"{row['library_block_ms']:.4f}, plain {row['plain_ms']:.4f}, bound "
                  f"{row['bound_ms']:.4f} ms")
            check(row["ms"] < row["nchw_ms"], f"nhwc_expand faster than the nchw kernels at "
                  f"{row['shape']}")
            k1x_rows.append(row)
            for k in ("entry_ms", "entry_wall_ms", "stock_ms", "ms", "wall_ms", "nchw_ms",
                      "library_block_ms", "bound_ms"):
                k1x_req[k] = k1x_req.get(k, 0.0) + blocks_per_forward * row[k]
            del x, fused, stock, p
    print(f"K1 nhwc_expand per request (stage 1 of B5 and B4: 4 and 3 stride-1 blocks a "
          f"forward, {sum(r['blocks_per_forward'] for r in k1x_rows)} blocks; sum of blocks x "
          f"time): entry {k1x_req['entry_ms']:.4f} ms (unheld {k1x_req['entry_wall_ms']:.4f}) "
          f"against the stock eval-mode blocks {k1x_req['stock_ms']:.4f}; passes alone "
          f"{k1x_req['ms']:.4f} (unheld {k1x_req['wall_ms']:.4f}), nchw kernels "
          f"{k1x_req['nchw_ms']:.4f}, library block {k1x_req['library_block_ms']:.4f}, bound "
          f"{k1x_req['bound_ms']:.4f}; {time.perf_counter() - t0:.1f} s")

    # ---- 4e. tiled serving of a full-resolution micrograph ---------------
    from enhanced_unet_tpu_torch import native
    from enhanced_unet_tpu_torch.metrics.instance import calculate_instance_metrics
    from enhanced_unet_tpu_torch.ops.preprocess import eval_preprocess
    from enhanced_unet_tpu_torch.ops.thresholding import convert_probs_to_mask
    from enhanced_unet_tpu_torch.ops.tiling import tile_grid
    from enhanced_unet_tpu_torch.postprocess import semantic_to_instances
    from enhanced_unet_tpu_torch.train.evaluator import _METRIC_KEYS

    del evaluator
    torch.cuda.empty_cache()
    tiled = Evaluator(model, "enhanced_unet", tiled=True, tile=TILE, overlap=TILE_OVERLAP)
    check(tiled.enable_tta and tiled.tile_batch is None,
          "tiled serving with TTA, the whole grid in one chunk")
    micrograph = synthetic_images(1, TILED_SIZE, 21)[0]
    n_tiles = len(tile_grid(TILED_SIZE, TILED_SIZE, TILE, TILE_OVERLAP)[2])
    forwards = []
    apply = tiled._apply

    def counting_apply(x):
        forwards[-1].append(tuple(x.shape))
        return apply(x)

    tiled._apply = counting_apply
    tiled_k2, tiled_k1 = {}, {}

    def recording_tiled_k2(x, packed, relu=True):
        key = tuple(x.shape) + (packed.cout,)
        tiled_k2[key] = tiled_k2.get(key, 0) + 1
        return packed_entry(x, packed, relu)

    def recording_tiled_k1(x, p, residual):
        key = (tuple(x.shape), p.wproj.shape[1])
        tiled_k1[key] = tiled_k1.get(key, 0) + 1
        return k1_entry(x, p, residual=residual)

    blocks.pack_conv3x3 = counting_pack
    encoders.fold_mbconv_weights = counting_fold
    packs.clear()
    folds.clear()
    tiled_walls, tiled_spans, tiled_launch_runs = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(3):
        blocks.fused_conv3x3_bn_relu_packed = recording_tiled_k2 if i == 0 else packed_entry
        encoders.mbconv_infer_nchw = recording_tiled_k1 if i == 0 else k1_entry
        packs.append(0)
        folds.append(0)
        forwards.append([])
        reset(counters)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        tiled_mask = tiled.predict_semantic_mask(micrograph)
        end.record()
        torch.cuda.synchronize()
        tiled_walls.append(1e3 * (time.perf_counter() - t0))
        tiled_spans.append(start.elapsed_time(end))
        tiled_launch_runs.append({k: v for c in counters for k, v in c.items()})
        counts = [int((tiled_mask == c).sum()) for c in range(3)]
        print(f"tiled request {i + 1}: {TILED_SIZE}^2, tile {TILE}, overlap {TILE_OVERLAP}, "
              f"TTA: wall {tiled_walls[-1]:.1f} ms, CUDA-event span {tiled_spans[-1]:.1f} ms, "
              f"forwards {forwards[-1]}, classes {counts}")
        check(tiled_mask.shape == (TILED_SIZE, TILED_SIZE) and tiled_mask.dtype == np.uint8,
              f"tiled mask {tiled_mask.shape} {tiled_mask.dtype}")
        check(sum(counts) == tiled_mask.size, "tiled mask values outside {0, 1, 2}")
        check(sum(1 for c in counts if c) >= 2, f"the tiled cascade decided only {counts}")
    tiled_peak = torch.cuda.max_memory_allocated()
    blocks.pack_conv3x3 = pack
    encoders.mbconv_infer_nchw, encoders.fold_mbconv_weights = k1_entry, fold
    blocks.fused_conv3x3_bn_relu_packed = packed_entry
    tiled._apply = apply
    tiled_launches = tiled_launch_runs[-1]
    print(f"tiled serving: {n_tiles} tiles a request, forwards {forwards[-1]}, peak memory "
          f"{tiled_peak} bytes, launches per request {json.dumps(tiled_launches)}, K2 packs "
          f"per request {packs}, K1 folds per request {folds}; K2 shapes "
          f"{sorted(tiled_k2.items())}; K1 shapes {sorted(tiled_k1.items())}")
    check(all(run == tiled_launches for run in tiled_launch_runs),
          "every tiled request launches the same kernels")
    check(forwards[-1] == [(3 * n_tiles, TILE, TILE, 3),
                           (n_tiles, TILE * 3 // 4, TILE * 3 // 4, 3),
                           (n_tiles, TILE * 5 // 4, TILE * 5 // 4, 3)],
          f"the whole grid in one chunk: the trio and two scales ({forwards[-1]})")
    for name in serving:
        check(tiled_launches[name] > 0, f"the tiled path launched {name}")
    tiled_off = {k: v for k, v in tiled_launches.items() if k not in serving}
    check(not any(tiled_off.values()), f"the tiled path launched {tiled_off}")
    check(sum(tiled_k2.values()) == tiled_launches["conv3x3_bn_act_wgmma"]
          + tiled_launches["conv3x3_bn_act_smallc"], "the recorded K2 calls are a request's")
    check(not any(packs[1:]) and not any(folds[1:]),
          f"no K2 pack or K1 fold after the first tiled request: {packs}, {folds}")
    tiled_groups = profile_run(lambda: tiled.predict_semantic_mask(micrograph),
                               min(tiled_walls[1:]), f"one tiled {TILED_SIZE}^2 request")
    # the host-stitched path (chunks of 8 tiles, probabilities downloaded)
    # and the whole path in chunks of 8 tiles, against the whole grid
    t0 = time.perf_counter()
    host_probs = tiled.predict_probs_tiled(micrograph)
    host_ms = 1e3 * (time.perf_counter() - t0)
    host_mask = convert_probs_to_mask(torch.from_numpy(host_probs)).numpy()
    host_share = float(np.mean(host_mask == tiled_mask))
    tiled.tile_batch = 8
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    chunked_mask = tiled.predict_semantic_mask(micrograph)
    chunked_ms = 1e3 * (time.perf_counter() - t0)
    chunked_peak = torch.cuda.max_memory_allocated()
    chunked_share = float(np.mean(chunked_mask == tiled_mask))
    print(f"tiled: host-stitched (chunks of 8) equals the device-stitched mask on "
          f"{host_share:.6f} of pixels ({int((host_mask != tiled_mask).sum())} differ; "
          f"{host_ms:.1f} ms); tile_batch=8 on {chunked_share:.6f} "
          f"({int((chunked_mask != tiled_mask).sum())} differ; {chunked_ms:.1f} ms, peak "
          f"memory {chunked_peak} bytes)")
    check(host_share >= 0.9999, "host-stitched within 99.99% of the device-stitched mask")
    check(chunked_share >= 0.9999, "tile_batch=8 within 99.99% of the whole grid")
    del tiled, host_probs
    # K2 at the fusion head's shapes in the tiled trio: its tensors hold
    # 2^31 elements and more (the kernels' offsets are 64-bit); each checked
    # against its plain version, five images at a time, and timed
    n_trio = 3 * n_tiles
    for cin, cout in ((6, 256), (256, 128), (128, 64)):
        x = torch.randn(n_trio, TILE, TILE, cin, generator=g, device=dev, dtype=torch.bfloat16)
        wt = torch.randn(3, 3, cin, cout, generator=g, device=dev) / (9 * cin) ** 0.5
        sc = torch.rand(cout, generator=g, device=dev) + 0.5
        sh = torch.randn(cout, generator=g, device=dev) * 0.1
        packed = conv_fused.pack_conv3x3(wt, sc, sh, torch.bfloat16, dev)
        with torch.no_grad():
            got = conv_fused.fused_conv3x3_bn_relu_packed(x, packed, True)
            rel = 0.0
            for i in range(0, n_trio, 5):
                want = conv_fused.fused_conv3x3_bn_relu_plain(x[i:i + 5], wt, sc, sh, True)
                rel = max(rel, ((got[i:i + 5].float() - want.float()).abs().max()
                                / want.float().abs().max()).item())
            del got, want
            ms = device_ms(lambda: conv_fused.fused_conv3x3_bn_relu_packed(x, packed, True), 5)
            wall = device_ms(lambda: conv_fused.fused_conv3x3_bn_relu_packed(x, packed, True),
                             5, held=False)
            library = device_ms(lambda: conv_library(x, wt, sc, sh, True), 5)
        b, kind = conv_bound(n_trio, TILE, TILE, cin, cout)
        print(f"[{card}] K2 at the tiled trio's [{n_trio},{TILE},{TILE},{cin}]->{cout} "
              f"({x.numel()} input, {n_trio * TILE * TILE * cout} output elements; "
              f"{packed.variant}): rel err {rel:.3e} (tol 2e-2), kernel {ms:.4f} ms (wall "
              f"{wall:.4f}), cuDNN conv + BN + ReLU {library:.4f} ms, bound {b:.4f} ms ({kind})")
        check(rel <= 2e-2, f"K2 at the tiled trio's {cin}->{cout} against its plain version")
        del x, packed
    torch.cuda.empty_cache()

    # ---- 4g. evaluate on the card: the reference's metric dict -----------
    batch = eval_batch(2, 512, 4)
    ev = Evaluator(model, "enhanced_unet", verbose=False)
    served = []
    predict = ev.predict_semantic_masks

    def recording_predict(imgs):
        out = predict(imgs)
        served.append(out)
        return out

    calls = {"rle_counts": 0, "pairwise_iou": 0}
    native_fns = {name: getattr(native, name) for name in calls}

    def counted(name):
        def run(*args):
            calls[name] += 1
            return native_fns[name](*args)
        return run

    ev.predict_semantic_masks = recording_predict
    for name in calls:
        setattr(native, name, counted(name))
    try:
        t0 = time.perf_counter()
        scores = ev.evaluate([batch])
        eval_wall = 1e3 * (time.perf_counter() - t0)
    finally:
        for name, fn in native_fns.items():
            setattr(native, name, fn)
    check(len(served) == 1 and served[0].shape == (2, 512, 512),
          "evaluate served the two images in one batch")
    labels = []
    host_t0 = time.perf_counter()
    for m, item in zip(served[0], batch["batch_items"]):
        masks_i, labels_i, scores_i = semantic_to_instances(m)
        labels.append(labels_i)
        calculate_instance_metrics(masks_i, labels_i, scores_i, item["instance_masks"],
                                   item["instance_labels"], native=True)
        for mm in masks_i + item["instance_masks"]:
            native.rle_counts(mm)
    host_per_image = 1e3 * (time.perf_counter() - host_t0) / len(served[0])
    print(f"evaluate on the card: {json.dumps(scores)}; wall {eval_wall:.1f} ms for 2 x "
          f"512^2; native calls {calls}; host (instances, instance metrics, RLE) "
          f"{host_per_image:.1f} ms per image")
    check(set(scores) == set(_METRIC_KEYS), "every metric key present")
    check(all(math.isfinite(v) for v in scores.values()), "every metric finite")
    for label, key in ((0, "pred_live_count"), (1, "pred_dead_count")):
        want = sum(sum(1 for x in c if x == label) for c in labels) / len(labels)
        check(scores[key] == want, f"{key} {scores[key]} is semantic_to_instances' {want}")
    check(native.load() is not None and calls["rle_counts"] > 0,
          "evaluate on the card used the native host ops")
    del ev

    # ---- 5. full-width cross-check against the fp32 CPU plain path ------
    # and 4f, the tiled path: one 256 x 448 image, tile 256, overlap 64
    # (two tiles), one view, its tiles' probabilities from the same enhanced
    # input
    x = torch.from_numpy(synthetic_images(1, 256, 7)) - 0.5
    wide = synthetic_images(1, 448, 8)[0, :256]
    card_tiled = Evaluator(model, "enhanced_unet", enable_tta=False, tiled=True, tile=256,
                           overlap=64)
    with torch.no_grad():
        got, _ = model(x.to(dev))
        enhanced = eval_preprocess(torch.from_numpy(wide).to(dev) * 255.0) / 255.0
        got_tiled = card_tiled.tiled_probs(enhanced[None])[0].cpu()
        del model, card_tiled
        torch.cuda.empty_cache()
        ref_model = serving_model(dtype=torch.float32, device="cpu")
        t0 = time.perf_counter()
        want, _ = ref_model(x)
        cpu_ms = 1e3 * (time.perf_counter() - t0)
        cpu_tiled = Evaluator(ref_model, "enhanced_unet", enable_tta=False, device="cpu",
                              tiled=True, tile=256, overlap=64)
        want_tiled = cpu_tiled.tiled_probs(enhanced[None].cpu())[0]
    err = (got.float().cpu() - want).abs().max().item()
    scale = want.abs().max().item()
    # bf16 activations through ~90 layers against fp32: about 2^-8 relative
    # rounding per layer, partly cancelling; 5e-2 of max |logit| allows it
    print(f"cross-check 256^2: bf16 card vs fp32 cpu max_abs_err {err:.4e}, "
          f"max |logit| {scale:.4e}, ratio {err / scale:.4e} (tol 5e-2); "
          f"cpu forward {cpu_ms / 1e3:.1f} s")
    check(torch.isfinite(got).all().item(), "finite logits")
    check(err <= 5e-2 * scale, "bf16 card path within 5e-2 of max |logit|")
    tiled_err = (got_tiled - want_tiled).abs().max().item()
    tiled_scale = want_tiled.abs().max().item()
    print(f"tiled cross-check 256 x 448 (tile 256, overlap 64, "
          f"{len(tile_grid(256, 448, 256, 64)[2])} tiles, one view): bf16 card vs fp32 cpu "
          f"probabilities max_abs_err {tiled_err:.4e}, max {tiled_scale:.4e} (tol 5e-2 of it)")
    check(tuple(got_tiled.shape) == (256, 448, 3) and torch.isfinite(got_tiled).all().item(),
          "finite tiled probabilities")
    check(tiled_err <= 5e-2 * tiled_scale, "tiled bf16 card path within 5e-2 of the cpu")

    del ref_model

    # ---- 6. the training step --------------------------------------------
    from enhanced_unet_tpu_torch.config import get_preset
    from enhanced_unet_tpu_torch.metrics.semantic import metrics_from_confusion
    from enhanced_unet_tpu_torch.models import get_model
    from enhanced_unet_tpu_torch.train.trainer import (
        create_train_state,
        make_eval_step,
        make_train_step,
    )

    # 6a. full width, train mode, the preset's dropout and stochastic depth
    torch.cuda.empty_cache()
    cfg = get_preset("enhanced_unet")
    t0 = time.perf_counter()
    model = get_model("enhanced_unet", seed=0)           # device None: the card
    state = create_train_state(model, cfg, STEPS_PER_EPOCH)
    train_step = make_train_step(cfg)
    imgs, masks, valid = (torch.from_numpy(a).to(dev)
                          for a in blob_batch(2, TRAIN_SIZE, TRAIN_PAD, 11))
    gen = torch.Generator(device=dev).manual_seed(0)
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats0 = {n: b.clone() for n, b in model.named_buffers() if "running" in n}
    print(f"train: enhanced_unet b5/b4 bf16, batch 2 x {TRAIN_PAD}^2 ({TRAIN_SIZE}^2 valid), "
          f"rates {model.fusion_dropout} / {model.drop_connect_rate} / {model.aspp_dropout}, "
          f"model and state in {time.perf_counter() - t0:.2f} s")
    reset(counters)
    torch.cuda.reset_peak_memory_stats()
    walls, device_times, losses = [], [], []
    for i in range(1 + TRAIN_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:
            dropped, undo = record_dropped_blocks(model)
        start.record()
        state, out = train_step(state, imgs, masks, valid, gen)
        end.record()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
        device_times.append(start.elapsed_time(end))
        losses.append(out["loss"].item())
        if i == 0:
            undo()
            check_gradients(model, dropped)
    peak = torch.cuda.max_memory_allocated()
    train_launches = {**conv_fused.LAUNCHES, **mbconv.LAUNCHES}
    print(f"train steps (1 warm + {TRAIN_STEPS}): wall ms {[round(t, 1) for t in walls]}, "
          f"device ms (CUDA events) {[round(t, 1) for t in device_times]}, peak memory "
          f"{peak} bytes, losses {[round(v, 4) for v in losses]}, K1/K2 launches "
          f"{json.dumps(train_launches)}")
    check(all(math.isfinite(v) for v in losses), f"finite losses {losses}")
    check(not any(train_launches.values()), "training launched no K1 or K2 kernel")
    moved = torch.stack([(p != params0[n]).any() for n, p in model.named_parameters()
                         if not n.startswith(UNCALLED)]).all().item()
    stats_moved = torch.stack([(b != stats0[n]).any() for n, b in model.named_buffers()
                               if n in stats0]).all().item()
    check(moved and stats_moved, "every called parameter and every running statistic changed")
    del params0, stats0
    stepped = []
    profile_run(
        lambda: stepped.append(train_step(state, imgs, masks, valid, gen)),
        min(walls[1:]), "one train step", TRAIN_GROUPS)
    state = stepped[0][0]

    # 6b. the eval step on the trained model: the fused kernels' path
    eval_step = make_eval_step(cfg)
    reset(counters)
    t0 = time.perf_counter()
    logits, cms = eval_step(state, imgs, masks, valid)
    torch.cuda.synchronize()
    eval_ms = 1e3 * (time.perf_counter() - t0)
    eval_launches = {**conv_fused.LAUNCHES, **mbconv.LAUNCHES}
    totals = cms.sum((1, 2)).tolist()
    scores = metrics_from_confusion(cms.sum(0).cpu().numpy())
    print(f"eval step: {eval_ms:.1f} ms (first call: packs and folds), launches "
          f"{json.dumps(eval_launches)}, confusion-matrix totals {totals}, "
          f"sem_mean_iou {scores['sem_mean_iou']:.4f}")
    check(torch.isfinite(logits).all().item(), "finite eval logits")
    check(tuple(cms.shape) == (2, 3, 3) and totals == [TRAIN_PAD * TRAIN_PAD] * 2,
          f"each confusion matrix sums to {TRAIN_PAD}^2: {totals}")
    for name in ("mbconv_nhwc_pass1", "mbconv_nhwc_pass2"):
        check(eval_launches[name] > 0, f"the eval step launched {name}")
    check(eval_launches["conv3x3_bn_act_wgmma"] + eval_launches["conv3x3_bn_act_smallc"] > 0,
          "the eval step launched K2")
    try:
        state.model(imgs)            # eval mode, grad enabled
    except RuntimeError as err:
        refused = str(err)
    else:
        refused = None
    print(f"eval-mode forward with grad enabled: {refused}")
    check(refused is not None and "no backward" in refused,
          "an eval-mode forward with grad enabled raises on the card")
    check({**conv_fused.LAUNCHES, **mbconv.LAUNCHES} == eval_launches,
          "the refused forward launched nothing")
    del model, state, logits, imgs, masks, valid, stepped
    torch.cuda.empty_cache()

    # 6c. one tiny step on the card against the CPU, fp32 and fp64
    t0 = time.perf_counter()
    batch = blob_batch(2, 56, 64, 5)
    steps = {(where, dt): tiny_train_step(cfg, where, dt, batch)
             for where in ("cpu", dev) for dt in (torch.float32, torch.float64)}
    cpu32, cpu64 = steps["cpu", torch.float32], steps["cpu", torch.float64]
    card32, card64 = steps[dev, torch.float32], steps[dev, torch.float64]
    noise = tree_rel_l2(cpu32["grads"], cpu64["grads"])
    grad32 = tree_rel_l2(card32["grads"], cpu32["grads"])
    grad64 = tree_rel_l2(card64["grads"], cpu64["grads"])
    loss_rel = abs(card32["loss"] - cpu32["loss"]) / abs(cpu32["loss"])
    stats_err = max((card32["stats"][n] - b).abs().max().item() / b.abs().max().item()
                    for n, b in cpu32["stats"].items())
    grad_tol = max(1e-3, 3 * noise)
    print(f"tiny step, card vs cpu: fp32 loss rel {loss_rel:.3e} (tol 1e-4), running "
          f"stats {stats_err:.3e} of max (tol 1e-4), gradient tree rel L2 {grad32:.3e} "
          f"(tol {grad_tol:.3e}: 1e-3, or 3 x the cpu's own fp32-to-fp64 distance "
          f"{noise:.3e} if larger); fp64 gradient tree rel L2 {grad64:.3e} (tol 1e-4); "
          f"{time.perf_counter() - t0:.1f} s")
    check(loss_rel <= 1e-4, "tiny fp32 loss within rtol 1e-4 of the cpu")
    check(stats_err <= 1e-4, "tiny fp32 running statistics within 1e-4 of the cpu")
    check(grad32 <= grad_tol, "tiny fp32 gradients within 1e-3 (or the fp32 noise) of the cpu")
    check(grad64 <= 1e-4, "tiny fp64 gradients within 1e-4 of the cpu")

    # ---- 7. the training entry point ---------------------------------------
    phase7_training_entry(card, counters, dev)

    # ---- 8. report -------------------------------------------------------
    meta = {
        "conv3x3_bn_act_wgmma": ("enhanced_unet_tpu_torch/csrc/conv3x3_bn_act.cu",
                                 "enhanced_unet_tpu/ops/pallas/conv_fused.py:109"),
        "conv3x3_bn_act_smallc": ("enhanced_unet_tpu_torch/csrc/conv3x3_bn_act.cu",
                                 "enhanced_unet_tpu/ops/pallas/conv_fused.py:109"),
        "conv3x3_bn_act_mma": ("enhanced_unet_tpu_torch/csrc/conv3x3_bn_act.cu",
                                 "enhanced_unet_tpu/ops/pallas/conv_fused.py:109"),
        "mbconv_nhwc_pass1": ("enhanced_unet_tpu_torch/csrc/mbconv_nhwc.cu",
                              "enhanced_unet_tpu/ops/pallas/mbconv.py:208"),
        "mbconv_nhwc_pass2": ("enhanced_unet_tpu_torch/csrc/mbconv_nhwc.cu",
                              "enhanced_unet_tpu/ops/pallas/mbconv.py:233"),
        "mbconv_nhwc_expand_pass1": ("enhanced_unet_tpu_torch/csrc/mbconv_nhwc_expand.cu",
                                     "enhanced_unet_tpu/ops/pallas/mbconv.py:208"),
        "mbconv_nhwc_expand_pass2": ("enhanced_unet_tpu_torch/csrc/mbconv_nhwc_expand.cu",
                                     "enhanced_unet_tpu/ops/pallas/mbconv.py:233"),
        "mbconv_pass1": ("enhanced_unet_tpu_torch/csrc/mbconv.cu",
                         "enhanced_unet_tpu/ops/pallas/mbconv.py:208"),
        "mbconv_pass2": ("enhanced_unet_tpu_torch/csrc/mbconv.cu",
                         "enhanced_unet_tpu/ops/pallas/mbconv.py:233"),
        "mbconv_proto": ("enhanced_unet_tpu_torch/csrc/mbconv_nhwc.cu, "
                         "enhanced_unet_tpu_torch/csrc/mbconv_nhwc_expand.cu",
                         "benchmarks/pallas_mbconv_proto.py:137/:162"),
        "mbconv_pass1_b2": ("enhanced_unet_tpu_torch/csrc/mbconv.cu",
                            "benchmarks/pallas_mbconv_instr.py:89"),
        "mbconv_pass2_b2": ("enhanced_unet_tpu_torch/csrc/mbconv.cu",
                            "benchmarks/pallas_mbconv_instr.py:99"),
        "dw3x3_bias_silu": ("enhanced_unet_tpu_torch/csrc/depthwise.cu",
                            "benchmarks/pallas_dw_variants.py:127/:131/:135/:145"),
        "dw_rows_silu": ("enhanced_unet_tpu_torch/csrc/depthwise.cu",
                         "benchmarks/pallas_mbconv_instr.py:81"),
        "copy": ("enhanced_unet_tpu_torch/csrc/copy.cu",
                 "benchmarks/pallas_mbconv_instr.py:76/:117"),
    }
    # launches, each from the run whose time and shape the entry reports:
    # the serving run's for its kernels, the benches' (3b) for theirs (B1:
    # stage 0; B2's passes on the `nchw` kernels), the general path's (phase
    # 3) for K2's mma variant, and phase 3's own cases for K1's
    # `nhwc_expand` kernels (the bf16 expand block) and `nchw` ones (the
    # fp32 block)
    path_launches = {**launches, **bench_launches, "conv3x3_bn_act_mma": general_launches,
                     **{k: case_launches["nhwc_expand"][k]
                        for k in ("mbconv_nhwc_expand_pass1", "mbconv_nhwc_expand_pass2")},
                     **{k: case_launches["nchw"][k] for k in ("mbconv_pass1", "mbconv_pass2")}}
    kernels = []
    for name, (source, replaces) in meta.items():
        r = results[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": path_launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "wall_ms": r["wall_ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"],
                        **({"tiled_launches": tiled_launches[name]} if name in serving
                           else {}),
                        **{k: r[k] for k in ("library_conv_ms", "library_block_ms", "nchw_ms",
                                             "yardstick_ms", "copy_ratio", "bf16_weights_ms")
                           if k in r},
                        "shape": r["shape"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
