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
    hold each kernel against its plain version and time it, and
    `dw_dilated_bn_silu_nhwc` (bf16, channels_last, dilation 2) at the
    twelve shapes of the DeepLab encoder's dilated blocks in a tiled 2048^2
    request (C 960 and 1632 at k5, 1632 and 2688 at k3, on [75,C,32,32],
    [25,C,24,24] and [25,C,40,40]), each within 2e-2 of max |value| of its
    plain version and 5e-2 of the stock sequence it replaced (`F.pad`,
    cuDNN's grouped conv, eval BN, SiLU; the library yardstick), and
    `dw3x3_bias_gelu_nhwc` at the twelve shapes of SegFormer-B5's Mix-FFN
    (3c: both entries the sums over a request); every depthwise, copy and
    MBConv count must move (B1 stage 0 reaches K1's
    `nhwc` kernels, stage 1 the `nhwc_expand` ones, B2's passes the `nchw`
    ones).  The benches' rows give the kernels' entries (B2's bf16 passes
    their own, beside the library's channels_last block on the same
    values), each depthwise kernel's `copy_ratio` (its held time over the
    copy kernel's) and the copy's measured bandwidth beside
    `Tensor.copy_`'s; then `dw3x3_bias_silu` with fp32 weights (the
    wrapper's cast in every call), and both depthwise kernels on the 2-byte
    path (odd W, a misaligned start) and at W = 520, against their plain
    versions;
 3c. the channels_last depthwise kernel's two epilogues summed over a tiled
    2048^2 request from 3b's rows (`depthwise_entries`): the dilated SiLU
    instances (30 launches on the flagship) and SegFormer-B5's Mix-FFN GELU
    instances (`dw3x3_bias_gelu_nhwc`: C 256, 512, 1280 and 2048 on its four
    stages' maps of the three forwards, 156 launches), each shape within
    2e-2 of its plain version and 5e-2 of the stock sequence (cuDNN's
    depthwise conv with bias, then GELU), the GELU instances faster than
    the stock sequence over the request;
 3d. the UNet++ decoder's scSE over a list of channel parts (`scse_parts`,
    bf16, channels_last) at a tiled 2048^2 request's 63 calls (the 21 of a
    forward, `SCSE_CALLS`, on [75,*,512,512], [25,*,384,384] and
    [25,*,640,640]), each within 2e-2 of max |value| of its plain version
    and 5e-2 of the stock sequence it replaced (nearest upsample,
    `torch.cat`, `SCSEBlock`'s stock calls), summed over the request
    (`scse_entry`), which it must beat, with the function's bytes bound
    (the parts read once) and the design's (read twice); phases 4 and 4e
    then check 63 calls a request, and its `kernels` entry takes 4e's;
 4. the slice: `get_model("enhanced_unet")` at full width (EfficientNet-B5
    UNet++ + EfficientNet-B4 DeepLabV3+, bf16, seeded random weights) served
    by an `Evaluator` with TTA: three requests of two 512x512 images; every
    count set to 0 before it; the serving kernels' counts (K2's wgmma and
    small-Cin variants, K1's two `nhwc` passes, and the DeepLab encoder's
    dilated depthwise kernel: 30 a request, ten blocks in each of three
    forwards) must move and every other
    count (K1's `nhwc_expand` and `nchw` kernels among them: the bf16
    request launches no `nchw` kernel) must not, and K2's plain version
    must not run; every logit finite; the first request records each shape
    K2 and K1 are called at, and no request after it may pack a conv's
    weights or fold an MBConv block's again; every K1 input must come
    channels_last with its folded weights already on the card; a profile
    (phases 4, 4e and 9 serve through one counted run, `serve_counted`);
 4b. K2 at every recorded serving shape (66: 22 per forward, three TTA
    forwards): checked against its plain version, timed (20 calls) beside
    the plain version (unheld), the `mma.sync` kernel, cuDNN + a torch epilogue and
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
    set to 0 before the first and read after each: a [2048,2048] uint8 mask with at least two
    classes; the 25 tiles in three forwards (the 75-tile trio, 25 at 384^2,
    25 at 640^2); K2's wgmma/small-Cin and K1's `nhwc` counts move, and the
    dilated depthwise kernel's by 30 a request, no other; no pack or fold
    after the first request; wall ms, CUDA-event
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
 4h. SegFormer-B5 at full size served as 4e serves the flagship (one
    2048x2048 micrograph, tile 512, overlap 64, TTA, the whole grid in one
    chunk): after a warm-up request every count is set to 0 and one more
    request served: a [2048,2048] uint8 mask, `dw3x3_bias_gelu_nhwc` (the
    Mix-FFN's depthwise kernel, D2) launched 156 times and no other counted
    kernel, its plain version never called, its weights laid out 52 times
    in the warm-up and never after; D2's `kernels` entry takes its launches
    from this request;
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
 7b. the user-facing entry points at full width on phase 7's micrographs
    and its `best_model`, every count set to 0 before each run and read
    after it (K1's `nhwc` and K2's wgmma/small-Cin kernels must launch, and
    no plain version of K1 or K2 may run): `evaluate_model` on the val
    split without figures, with them and without (every metric key present
    and finite, the results JSON written, the 22 figures as PNG and SVG and
    the cell-count CSV written, no figure warning; its seconds, the
    figures' share and peak memory); `predict_model` (on phase 4's seeded
    serving weights, checkpointed: phase 7's best_model may decide no cell
    yet, which would leave the count check vacuous) over the 3 test
    micrographs, batched
    at max_size 640 (one chunk) and tiled at 2048 (full resolution, 1344 x
    1024, tile 512, overlap 64), two runs each, the first warm (a row and
    two PNGs an image, cells found, each row's counts those of
    `semantic_to_instances` on the mask the card returned; serving ms per
    image from `StepTimer`, whole-call ms per image with the call's model
    build and checkpoint load, peak memory); one more batched run with its
    chunk under `trace_context` (a trace with the card's kernels);
    `visualize_model(regenerate_predictions=True)` (returns the saved
    results); `initialize_pretrained` into the full-width flagship on the
    card from seeded upstream-layout b5/b4 files (the encoders' keys plus
    efficientnet-pytorch's classifier head): `verify=True` refuses the
    files under the manifest's names and writes nothing, then takes copies
    named after their own SHA256 prefix; every encoder tensor equals its
    file's, every other tensor is unchanged.  Without matplotlib the phase
    says so on a line of its own and runs `evaluate_model` without
    figures and no `visualize_model`;
 9. the rest of the zoo, inside phase 7's temporary directory: each of
    segnet, unet (ResNet-50), unet_basic, enhanced_unet_basic, fcn (FPN
    over ResNet-18), fcn_basic, pspnet (ResNet-34), pspnet_basic, linknet
    (ResNet-18) and linknet_basic at full width, bf16, seeded weights:
    an `Evaluator` with the preset's TTA (enhanced_unet_basic's only)
    serves phase 4's three requests of two 512^2 images, every count set
    to 0 before the first: [2,512,512] masks in {0,1,2}, every logit
    finite, K2 launches per request as each flax tree has them (wgmma, and
    small-Cin where the first 3x3 conv takes 3 channels), no other kernel,
    no plain version of K2, no pack after the first request; warm wall ms,
    CUDA-event span and peak memory; one 256^2 image bf16 on the card
    against fp32 on the CPU (5e-2 of max |logit|, each pixel's class the
    same on 99% of pixels; for SegNet the logits are held against the CPU
    replaying the card's pool indices, and each pool's share of windows
    the CPU decides otherwise must stay under 5%); one warm and two timed
    train steps at 2 x 256^2 (finite losses, every parameter and running
    statistic changed, no K1 or K2 launch).  Then K2 at every zoo shape
    phase 4 did not give it, checked and timed as in 4b, and summed over
    each model's request; and unet through the entry points on
    phase 7's folder: `train_model` for one epoch with the full-Evaluator
    gate (K2 launched), `predict_model` batched on its `best_model` (a row
    per micrograph, K2 launched, no plain version);
9b. the CLI and the data axis, inside phase 7's temporary directory, the
    flagship and unet at full width, bf16: (a) `cli.main` in-process on
    phase 7's folder, every count set to 0 before each call: `--mode
    train_eval --epochs 1` (rc 0; both models evaluated, not isolated as
    zeros, every metric finite; the CSV header `CSV_COLUMNS`; the
    checkpoints; K1's `nhwc` and K2's wgmma/small-Cin kernels launched,
    no plain version of K1 or K2; the comparison figures where matplotlib
    imports, else a line saying they were not rendered), `--mode predict
    --tiled` over the 3 test micrographs at full resolution (a row each),
    `--mode eval --eval-batch 2`, `--mode manifest` (the manifest's lines)
    and, only with matplotlib, `--mode visualize`; each call's seconds;
    (b) the data-parallel step at world size 1 over NCCL against the plain
    step from the same state, 2 x 640^2 (phase 6a's batch), three steps a
    path, plain / data-parallel / plain: the step times, the median
    difference and the reductions' own wall ms (the cost of the reductions
    on one card), the first step's clipped gradient's relative L2 between
    the paths beside the plain step's own run-to-run difference (at most
    10 times it, or 1e-5), and the same for the update after three steps;
    (d) `tiled_inference_sharded` at world size 1 on one seeded 2048^2
    micrograph, tile 512, overlap 64, twice (the first call, then warm),
    against `ops/tiling.tiled_inference` on the same serving weights
    (within 5e-2 of the probabilities, each pixel's class the same on
    0.9999 of them), K1 and K2 launched and no plain version; (c) two
    spawned processes sharing the card over gloo (the only place the
    cross-rank reduction runs on CUDA tensors), each with its own 2 x
    640^2 batch, `replicate_state` from differently seeded weights, two
    steps: every parameter and running statistic bitwise equal across the
    ranks, each reported loss the mean of the ranks' local losses; their
    times, labelled as two processes on one card;
9c. spatial partitioning (`parallel/spatial.py`), inside phase 7's temporary
    directory: the flagship (full width, bf16, phase 4's weights) and
    BasicUNet on one seeded 2048^2 micrograph, each model's own forward in
    one process first (its wall ms and peak memory); (a) at world size 1
    over NCCL, `make_spatial_apply` of the flagship and
    `make_spatial_basic_unet`, each the first call, then warm; (b) two
    spawned ranks sharing the card over gloo, 1,024 rows a rank: the
    flagship at 2048^2 (neighbour halos only), the flagship at 512^2 (256
    rows a rank: ASPP's stride-16 map has 16 rows a band, so its dilated
    convolutions take the gathered path) and BasicUNet at 2048^2, each the
    first call, then warm.  Every run, every count set to 0 before each
    call: masks (the class of each pixel) of the image's shape in {0,1,2},
    finite logits within 5e-2 of max |logit| of the one-process forward
    with each pixel's class the same on 0.9999 of pixels, K2 launched (and
    for the flagship K1's windowed `nhwc` pass 1 and its pass 2, no
    unwindowed pass 1, every launch one of the recorded K2 and K1 calls),
    no other kernel and no plain version; wall ms and each rank's peak
    memory beside the one process's.  (c) K2 at each shape the flagship's
    call at world size 1 gave it (its haloed bands), checked and timed as
    in 4b (10 calls a timing) and summed over the call.  (d) K1 at each
    band the flagship's calls gave it (world size 1: [1,48|24,1026,1024];
    two ranks: [1,48|24,514,1024] and, at 512^2, [1,48|24,130,256]), cut
    from a seeded whole map as the path cuts them: the `nhwc` windowed pass
    1 and pass 2 with the block's own folded weights, and the fp32
    row-streaming windowed pass 1 with a seeded fp32 block, against their
    plain version (bf16 within 2e-2 of max |value|, fp32 within 1e-4), the
    bands' sums against the whole map's, timed beside the plain version,
    pass 1 beside the launch without its window, and the bound;
9d. tensor parallelism's forward (`parallel/tensor_parallel.py`), inside
    phase 7's temporary directory: the flagship (full width, bf16, phase 4's
    weights) on one seeded 2 x 512^2 batch, its own forward in one process
    first (wall ms, peak memory, parameter bytes); then `shard_params_tp`
    at `min_channels` 128 and `make_tp_apply` on (a) the grid
    `make_mesh_2d(1, 1)` over NCCL and (b) `make_mesh_2d(1, 2)`, two spawned
    ranks sharing the card over gloo, each the first call, then warm, then
    one call with each collective timed from an idle device (an upper bound
    of the collectives' cost: the wait for the peer included), every count
    set to 0 before each call: finite logits within 5e-2 of max |logit| of
    the one process's with each pixel's class the same on 0.9999 of pixels;
    the mode's all-gathers and all-reduces; K2's launches by variant and by
    split (whole, column, row without an epilogue; never a row split with
    its ReLU), K1's `nhwc` passes on whole weights, no other kernel and no
    plain version; each rank's peak memory and parameter bytes (at 1 x 2
    the 267 column-split and 4 row-split weights hold half their bytes).
    (c) K2 at each shape the 1 x 2 call gave it that phase 4b did not,
    checked and timed as in 4b (10 calls a timing) and summed over the
    call; K1 at each shape the 1 x 2 call gave it ([2,48|24,256,256]), with
    the block's own folded weights from that call: the entry against
    `mbconv_infer_nchw_plain` and each pass against its plain version, timed
    beside it and the bound; and what the row split's bf16 partial sums
    cost in error at the widest row-split shape: the path's result and K2's
    fused epilogue, each against conv + BN + ReLU in fp32;
9e. tensor parallelism's train step and the Evaluator's mesh, inside phase
    7's temporary directory: (a) `make_tp_train_step` on the flagship at
    full width (phase 6a's weights and dtype, the preset's dropout and
    stochastic depth), a seeded global batch of 2 x 512^2 blob micrographs,
    `min_channels` 128, three steps a grid from a generator seeded alike,
    every count set to 0 before each step, on the grids 1 x 1 (NCCL), 1 x 2
    and 2 x 1 (two spawned ranks sharing the card over gloo): each step's
    loss, global gradient norm and wall ms (the first, then warm), each
    rank's peak and its parameter and AdamW-moment bytes beside the one
    process's, the collectives a step by kind; the first loss within 1e-2
    of one step of the one-process `make_train_step` at the same weights
    and seed (its gradient norm beside), every rank reporting the same
    losses, no K1 or K2 launch and no plain version (train mode is stock),
    every split weight and its moments at width / n_model (271 of them on
    1 x 2) and, after the third step, every whole parameter, its moments and
    every running statistic equal across the ranks; beside them the same
    one-process step in fp32 (how far bf16 alone moves the loss and the
    norm); the gradients in float64 against one process's float64 step:
    the 1 x 1 grid at the batch, the two-rank grids at 2 x 128^2, and the
    efficientnet-tiny flagship (2 x 64^2, split at `min_channels` 16) on the
    two-rank grids, each the loss within 1e-6 and the gradient tree within
    1e-5 (relative L2); and how far the gradient trees of one step are
    apart in bf16 and fp32, however reduced: the one process's and the 1 x 1
    grid's from each other and from the float64 step, at the batch and at 8
    x 256^2, with the furthest parameters; (b) `Evaluator(tiled=
    True, tile 512, overlap 64, TTA, mesh=...)` on a seeded 2048^2
    micrograph (phase 4's weights) at world size 1 (NCCL) and on the two
    ranks: `predict_probs_tiled` within 5e-2 of the max probability of one
    process's (no mesh) and `predict_semantic_mask` (the host-stitched
    path) with each pixel's class the same as one process's on 0.9999 of
    pixels, each request's wall ms (first, warm), each rank's tile shares,
    K1's `nhwc` and K2's wgmma/small-Cin kernels launched with no plain
    version; K2 at each shape the two-rank chunks gave it that phase 4b did
    not hold, and K1 at each of their shapes, checked and timed as in 9d (c);
10. a `{"kernels": [...]}` line, each entry's launches counted in the run
    whose time and shape it reports (the dilated depthwise kernel's, whose
    time sums a tiled request's shapes, per tiled request, with each shape's
    row in `request_shapes`; the serving kernels' also per tiled
    request, `tiled_launches`; K2's also per zoo request, `zoo_launches`;
    the serving kernels' per tensor-parallel call on the 1 x 2 grid,
    `tp_launches`, with K2's and K1's rows at 9d's shapes, `tp_shapes`; and
    per mesh-served tiled request of one of two ranks, `mesh_launches`,
    with their rows at its chunk's shapes, `mesh_shapes`), the card line,
    and the final JSON line.

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


def phase7_training_entry(card: str, counters, dev, after=None):
    """7. The training entry point on the card: `train_model` from a folder
    of micrographs, its gate, resume, the device pipeline against the CPU,
    and the step with and without prefetch (see the module docstring); then
    7b, and `after(tmp, data_dir)` inside the same temporary directory,
    whose result it returns."""
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
        phase7b_entry_points(card, counters, dev, tmp, data_dir, best)
        out = None if after is None else after(tmp, data_dir)
    torch.cuda.empty_cache()
    return out


PREDICT_RUNS = 2                  # phase 7b: timed predict_model runs a mode, the first warm


def effnet_files(model, out_dir: str, seed: int) -> dict:
    """Upstream-layout (efficientnet-pytorch) weight files for the model's
    two encoders, seeded: the encoders' own keys and shapes plus the
    classifier head (`_conv_head`, `_bn1`, `_fc`), each written under the
    manifest's name and under a name that carries its own SHA256 prefix.
    Returns {variant: (state dict, own name)}."""
    import hashlib
    import os

    import torch

    from enhanced_unet_tpu_torch.convert.pretrained import WEIGHT_MANIFEST

    g = torch.Generator().manual_seed(seed)
    out = {}
    for variant, path in (("efficientnet-b5", "unetpp.encoder"),
                          ("efficientnet-b4", "deeplab.encoder")):
        sd = {}
        for k, v in model.get_submodule(path).state_dict().items():
            if k.endswith("num_batches_tracked"):
                sd[k] = torch.tensor(1000)
            elif k.endswith("running_var"):
                sd[k] = torch.rand(v.shape, generator=g) + 0.5
            else:
                sd[k] = torch.randn(v.shape, generator=g) * 0.05
        last = max(int(k.split(".")[1]) for k in sd if k.startswith("_blocks."))
        cin = sd[f"_blocks.{last}._project_conv.weight"].shape[0]
        head = 4 * cin                                  # round_filters(1280) for b4/b5
        sd.update({"_conv_head.weight": torch.randn(head, cin, 1, 1, generator=g),
                   "_bn1.weight": torch.ones(head), "_bn1.bias": torch.zeros(head),
                   "_bn1.running_mean": torch.zeros(head), "_bn1.running_var": torch.ones(head),
                   "_bn1.num_batches_tracked": torch.tensor(1000),
                   "_fc.weight": torch.randn(1000, head, generator=g) * 0.01,
                   "_fc.bias": torch.zeros(1000)})
        manifest_path = os.path.join(out_dir, WEIGHT_MANIFEST[variant]["file"])
        torch.save(sd, manifest_path)
        with open(manifest_path, "rb") as f:
            h8 = hashlib.sha256(f.read()).hexdigest()[:8]
        own = f"{variant}-{h8}.pth"
        os.link(manifest_path, os.path.join(out_dir, own))
        out[variant] = (sd, own)
    return out


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


def phase7b_entry_points(card: str, counters, dev, tmp: str, data_dir: str, best: str) -> None:
    """7b. The user-facing entry points at full width on phase 7's
    micrographs and `best_model` (see the module docstring)."""
    import os

    import torch

    from enhanced_unet_tpu_torch.config import get_preset
    from enhanced_unet_tpu_torch.convert import pretrained
    from enhanced_unet_tpu_torch.data.dataset import CellDataset, snap_to_multiple
    from enhanced_unet_tpu_torch.ops.kernels import conv_fused, mbconv
    from enhanced_unet_tpu_torch.postprocess import semantic_to_instances
    from enhanced_unet_tpu_torch.train import api
    from enhanced_unet_tpu_torch.train.checkpoint import save_checkpoint
    from enhanced_unet_tpu_torch.train.evaluator import _METRIC_KEYS, Evaluator
    from enhanced_unet_tpu_torch.train.trainer import create_train_state
    from enhanced_unet_tpu_torch.utils import StepTimer, trace_context

    try:
        import matplotlib  # noqa: F401
        figures = True
    except ImportError:
        figures = False
        print(f"[{card}] matplotlib is not installed on this machine: evaluate_model runs "
              "with generate_visualizations=False, visualize_model is not run")

    def k1_k2(what):
        launches = {**conv_fused.LAUNCHES, **mbconv.LAUNCHES}
        check(launches["mbconv_nhwc_pass1"] > 0 and launches["mbconv_nhwc_pass2"] > 0,
              f"{what} launched K1")
        check(launches["conv3x3_bn_act_wgmma"] + launches["conv3x3_bn_act_smallc"] > 0,
              f"{what} launched K2")
        check(plain == {"conv3x3_bn_act": 0, "mbconv": 0},
              f"{what} ran no plain version of K1 or K2 ({plain})")
        return {k: v for k, v in launches.items() if v}

    cfg = get_preset("enhanced_unet")
    results_dir = os.path.join(tmp, "results")
    save_dir = os.path.join(results_dir, "enhanced_unet")
    plain, restore = count_plain()
    try:
        # evaluate_model on the val split: without figures, with them, without
        logs, seconds, launches, peaks = [], {}, {}, []
        for run, figs in enumerate((False, figures, False)):
            reset(counters)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            results = api.evaluate_model("enhanced_unet", data_dir, best,
                                         results_dir=results_dir, max_size=ENTRY_MAX_SIZE,
                                         generate_visualizations=figs, log=logs.append)
            torch.cuda.synchronize()
            seconds.setdefault(figs, []).append(time.perf_counter() - t0)
            peaks.append(torch.cuda.max_memory_allocated())
            launches[run] = k1_k2("evaluate_model")
        with open(os.path.join(save_dir, "enhanced_unet_results.json")) as f:
            saved = json.load(f)
        plain_s = min(seconds[False])
        fig_s = seconds[True][0] if figures else None
        written = sorted(os.listdir(save_dir))
        print(f"[{card}] evaluate_model enhanced_unet b5/b4 bf16 on the val split "
              f"(1 micrograph {MICROGRAPH_HW[1]} x {MICROGRAPH_HW[0]} -> "
              f"{ENTRY_MAX_SIZE} max side), TTA, best_model of phase 7: "
              f"{[round(v, 3) for v in seconds[False]]} s without figures"
              + (f", {fig_s:.3f} s with them (figures' share "
                 f"{(fig_s - plain_s) / fig_s:.3f}), {len(written)} files written"
                 if figures else "")
              + f"; peak memory {peaks} bytes; launches {json.dumps(launches[0])}; "
              f"metrics {json.dumps(results)}")
        warnings = [m for m in logs if "warning" in m.lower()]
        check(set(results) == set(_METRIC_KEYS)
              and all(math.isfinite(v) for v in results.values()),
              "evaluate_model gives every metric, finite")
        check(saved == results, "evaluate_model wrote its results JSON")
        check(not warnings, f"evaluate_model logged no warning ({warnings})")
        if figures:
            expected = {"training_curves", "class_wise_metrics", "learning_rate",
                        "gradient_flow", "sample_grid", "confusion_matrix", "predictions",
                        "cell_statistics", "per_image_metrics", "error_analysis",
                        "class_distribution", "spatial_analysis", "roc_curves", "pr_curves",
                        "boundary_accuracy", "size_performance", "calibration",
                        "paper_fig1_comparison", "paper_fig2_overlay", "paper_fig3_errors",
                        "paper_fig4_detailed", "cell_count_comparison"}
            want = ({f"enhanced_unet_{b}.{e}" for b in expected for e in ("png", "svg")}
                    | {"enhanced_unet_cell_count_comparison.csv",
                       "enhanced_unet_results.json"})
            check(set(written) == want and all(
                os.path.getsize(os.path.join(save_dir, f)) > 0 for f in written),
                f"evaluate_model wrote the figure suite ({sorted(want - set(written))} "
                f"missing, {sorted(set(written) - want)} extra)")

        # predict_model over the test split: batched at 640, tiled at full
        # resolution.  Phase 7's three epochs may leave the cascade deciding
        # background everywhere, which would make the count check below
        # vacuous, so predict_model serves phase 4's seeded weights (output
        # convs scaled), which decide cells, from a checkpoint of their own
        served_ckpt = os.path.join(tmp, "serving_model")
        save_checkpoint(served_ckpt, create_train_state(serving_model(device=dev), cfg, 1,
                                                        device=dev),
                        0, 0.0, float("inf"), {})
        test_dir = os.path.join(tmp, "test_images")
        os.makedirs(test_dir)
        names = CellDataset(data_dir, "test").files
        for name in names:
            os.link(os.path.join(data_dir, name), os.path.join(test_dir, name))
        real_one, real_many = Evaluator.predict_semantic_mask, Evaluator.predict_semantic_masks
        real_build, real_load = api._build_state, api.load_checkpoint
        spent = {}

        def timed(key, fn):
            def run(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                spent[key] = spent.get(key, 0.0) + time.perf_counter() - t0
                return out
            return run

        modes = {"batched": dict(max_size=ENTRY_MAX_SIZE),
                 "tiled": dict(max_size=TILED_SIZE, tiled=True, tile=TILE, overlap=TILE_OVERLAP)}
        for mode, kw in modes.items():
            per_call = len(names) if mode == "batched" else 1
            timer, served, totals = StepTimer(warmup=len(names) // per_call), [], []
            # batched: one more run, its one chunk under trace_context, untimed
            traced = [False]

            def one(self, img):
                timer.start()
                mask = real_one(self, img)
                timer.stop()
                served.append(mask)
                return mask

            def many(self, imgs):
                if traced[0]:
                    with trace_context(os.path.join(tmp, "trace")):
                        masks = real_many(self, imgs)
                else:
                    timer.start()
                    masks = real_many(self, imgs)
                    timer.stop()
                served.extend(masks)
                return masks

            Evaluator.predict_semantic_mask, Evaluator.predict_semantic_masks = one, many
            api._build_state = timed("model build", real_build)
            api.load_checkpoint = timed("checkpoint load", real_load)
            try:
                for run in range(PREDICT_RUNS + (mode == "batched")):
                    traced[0] = run == PREDICT_RUNS
                    served.clear()
                    spent.clear()
                    reset(counters)
                    torch.cuda.reset_peak_memory_stats()
                    t0 = time.perf_counter()
                    out = api.predict_model("enhanced_unet", test_dir, served_ckpt,
                                            results_dir=os.path.join(tmp, f"predict_{mode}"),
                                            log=lambda *a: None, **kw)
                    if not traced[0]:
                        totals.append(1e3 * (time.perf_counter() - t0) / len(names))
                        peak = torch.cuda.max_memory_allocated()
                        parts = dict(spent)
                    got = k1_k2(f"predict_model ({mode})")
            finally:
                Evaluator.predict_semantic_mask, Evaluator.predict_semantic_masks = (real_one,
                                                                                     real_many)
                api._build_state, api.load_checkpoint = real_build, real_load
            shape = snap_to_multiple(*MICROGRAPH_HW, kw["max_size"])
            rows = out["predictions"]
            counts = [semantic_to_instances(m)[1] for m in served]
            summary = timer.summary(items_per_step=per_call)
            print(f"[{card}] predict_model {mode} ({len(names)} test micrographs -> "
                  f"{shape[1]} x {shape[0]}" + (f", tile {TILE} overlap {TILE_OVERLAP}"
                                                 if mode == "tiled" else ", one chunk")
                  + f"): serving {1e3 / summary['items_per_sec']:.1f} ms per image "
                  f"(StepTimer, {summary['steps']} warm calls), whole call "
                  f"{[round(v, 1) for v in totals]} ms per image (of the last call, for all "
                  f"{len(names)} images: "
                  + ", ".join(f"{k} {1e3 * v:.1f} ms" for k, v in parts.items())
                  + "; the rest serving, decode, instances and PNGs), peak memory "
                  f"{peak} bytes; launches "
                  f"{json.dumps(got)}; rows {json.dumps(rows)}")
            check([r["filename"] for r in rows] == names and len(served) == len(names),
                  f"predict_model ({mode}) gives a row and a mask for each image")
            check(all(m.shape == shape for m in served), f"predict_model ({mode}) at {shape}")
            check(sorted(os.listdir(out["save_dir"])) == sorted(
                [f"{os.path.splitext(n)[0]}_{k}.png" for n in names for k in ("mask", "overlay")]
                + ["predictions.csv"]), f"predict_model ({mode}) wrote two PNGs an image")
            check(sum(r["total_count"] for r in rows) > 0,
                  f"predict_model ({mode}) found cells")
            check(all(r["live_count"] == sum(1 for c in lab if c == 0)
                      and r["dead_count"] == sum(1 for c in lab if c == 1)
                      and r["live_pixels"] == int((m == 1).sum())
                      for r, lab, m in zip(rows, counts, served)),
                  f"predict_model ({mode}) counts are those of the card's masks")
        trace = os.path.join(tmp, "trace", "trace.json")
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        kernels = sum(1 for e in events if e.get("cat") == "kernel")
        print(f"[{card}] trace_context around one predict_model chunk: {trace} "
              f"{os.path.getsize(trace)} bytes, {len(events)} events, {kernels} kernel events")
        check(kernels > 0, "the chunk's trace holds the card's kernels")

        # visualize_model: the history, the saved results, the figures again
        if figures:
            reset(counters)
            t0 = time.perf_counter()
            again = api.visualize_model("enhanced_unet", data_dir, checkpoint_path=best,
                                        results_dir=results_dir, regenerate_predictions=True,
                                        max_size=ENTRY_MAX_SIZE, log=lambda *a: None)
            vis_launches = k1_k2("visualize_model")
            print(f"[{card}] visualize_model(regenerate_predictions=True): "
                  f"{time.perf_counter() - t0:.3f} s; launches {json.dumps(vis_launches)}")
            check(again == results, "visualize_model returns the saved results")
            check(os.path.exists(os.path.join(save_dir,
                                              "enhanced_unet_training_history.csv")),
                  "visualize_model wrote the history CSV")
    finally:
        restore()

    # ImageNet encoders into the full-width flagship on the card
    weights = os.path.join(tmp, "weights")
    os.makedirs(weights)
    state = api._build_state("enhanced_unet", cfg, 1, torch.bfloat16, dev)
    before = {k: v.cpu().clone() for k, v in state.model.state_dict().items()}
    t0 = time.perf_counter()
    files = effnet_files(state.model, weights, 17)
    write_s = time.perf_counter() - t0
    try:
        pretrained.initialize_pretrained(state, "enhanced_unet", weights_dir=weights,
                                         log=lambda *a: None)
        refused = False
    except ValueError as err:
        refused = "SHA256" in str(err)
    unchanged = all(torch.equal(v.cpu(), before[k])
                    for k, v in state.model.state_dict().items())
    check(refused and unchanged, "verify=True refuses the manifest-named files, writes nothing")
    manifest = {v: dict(e, file=files[v][1], sha256_prefix=files[v][1][-12:-4])
                if v in files else e for v, e in pretrained.WEIGHT_MANIFEST.items()}
    real_manifest, pretrained.WEIGHT_MANIFEST = pretrained.WEIGHT_MANIFEST, manifest
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, imported = pretrained.initialize_pretrained(state, "enhanced_unet",
                                                       weights_dir=weights, log=lambda *a: None)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        pretrained.WEIGHT_MANIFEST = real_manifest
    after = state.model.state_dict()
    n_enc = exact = other = 0
    for k, v in after.items():
        prefix = next((p for p in ("unetpp.encoder.", "deeplab.encoder.") if k.startswith(p)),
                      None)
        if prefix is None:
            other += torch.equal(v.cpu(), before[k])
            continue
        variant = "efficientnet-b5" if prefix.startswith("unetpp") else "efficientnet-b4"
        n_enc += 1
        exact += torch.equal(v.cpu(), files[variant][0][k[len(prefix):]].to(v.dtype))
    print(f"[{card}] initialize_pretrained into the full-width flagship on the card: files "
          f"{[files[v][1] for v in files]} written in {write_s:.1f} s, verified and loaded in "
          f"{load_s:.2f} s; {exact} of {n_enc} encoder tensors equal the files', {other} of "
          f"{len(after) - n_enc} other tensors unchanged; imported {imported}")
    check(imported == ["efficientnet-b5", "efficientnet-b4"], "both encoders imported")
    check(exact == n_enc and other == len(after) - n_enc,
          "every encoder tensor equals its file's and every other tensor is unchanged")
    del state, before, after, files
    torch.cuda.empty_cache()


def serve_counted(evaluator, requests, counters, what: str, serve=None) -> dict:
    """Serves `requests` (arrays in [0, 1], [..., H, W, 3]) through `serve`
    (`evaluator.predict_semantic_masks` by default), every count set to 0
    before the first, and checks what every serving run must hold: integer
    masks [..., H, W] in {0,1,2}, every logit finite, no plain version of
    K2 run, no K2 weight pack or K1 fold after the first request, and every
    K2 and K1 launch one that the first request recorded.  The first
    request records each shape K2 is called at, and each K1 call with one
    block's folded weights and whether its input came channels_last and its
    folded weights sat on the card in the kernel's dtype (so the wrapper
    copies nothing).  Returns those records, per request the packs, folds,
    forward input shapes, wall and CUDA-event span ms, masks and launches
    (`runs`), and the run's launches and peak memory."""
    import numpy as np
    import torch

    from enhanced_unet_tpu_torch.models import blocks, encoders
    from enhanced_unet_tpu_torch.ops.kernels import conv_fused

    k2_entry, pack = blocks.fused_conv3x3_bn_relu_packed, blocks.pack_conv3x3
    k1_entry, fold = encoders.mbconv_infer_nchw, encoders.fold_mbconv_weights
    k2_plain, apply = conv_fused.fused_conv3x3_bn_relu_plain, evaluator._apply
    serve = serve or evaluator.predict_semantic_masks
    k2_calls, k1_calls, k1_inputs = {}, {}, set()
    packs, folds, forwards, finite, plain = [], [], [], [], [0]

    def recording_k2(x, packed, relu=True):
        key = (tuple(x.shape) + (packed.cout,), relu)
        k2_calls[key] = k2_calls.get(key, 0) + 1
        return k2_entry(x, packed, relu)

    def recording_k1(x, p, residual):
        key = (tuple(x.shape), p.wproj.shape[1], residual)
        k1_calls.setdefault(key, [0, p])[0] += 1
        k1_inputs.add((x.is_contiguous(memory_format=torch.channels_last),
                       p.wdw.dtype == x.dtype and all(
                           t.device == x.device and t.is_contiguous()
                           for t in (p.wdw, p.bdw, p.bproj))))
        return k1_entry(x, p, residual=residual)

    def counting_pack(*args):
        packs[-1] += 1
        return pack(*args)

    def counting_fold(*args, **kwargs):
        folds[-1] += 1
        return fold(*args, **kwargs)

    def counted_plain(*args, **kwargs):
        plain[0] += 1
        return k2_plain(*args, **kwargs)

    def checked_apply(x):
        out = apply(x)
        forwards[-1].append(tuple(x.shape))
        finite.append(torch.isfinite(out).all())
        return out

    blocks.pack_conv3x3, encoders.fold_mbconv_weights = counting_pack, counting_fold
    conv_fused.fused_conv3x3_bn_relu_plain, evaluator._apply = counted_plain, checked_apply
    walls, spans, masks, runs = [], [], [], []
    try:
        reset(counters)
        torch.cuda.reset_peak_memory_stats()
        for i, imgs in enumerate(requests):
            blocks.fused_conv3x3_bn_relu_packed = recording_k2 if i == 0 else k2_entry
            encoders.mbconv_infer_nchw = recording_k1 if i == 0 else k1_entry
            packs.append(0)
            folds.append(0)
            forwards.append([])
            before = {k: v for c in counters for k, v in c.items()}
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            out = serve(imgs)
            end.record()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
            spans.append(start.elapsed_time(end))
            runs.append({k: v - before[k] for c in counters for k, v in c.items()})
            check(out.shape == imgs.shape[:-1] and out.dtype.kind in "iu",
                  f"{what}: masks {out.shape} {out.dtype}")
            check(set(np.unique(out).tolist()) <= {0, 1, 2},
                  f"{what}: mask values outside {{0, 1, 2}}")
            masks.append(out)
    finally:
        blocks.fused_conv3x3_bn_relu_packed, blocks.pack_conv3x3 = k2_entry, pack
        encoders.mbconv_infer_nchw, encoders.fold_mbconv_weights = k1_entry, fold
        conv_fused.fused_conv3x3_bn_relu_plain, evaluator._apply = k2_plain, apply
    launches = {k: v for c in counters for k, v in c.items()}
    check(finite and all(bool(f) for f in finite), f"{what}: every logit finite")
    check(plain[0] == 0, f"{what} ran no plain version of K2 ({plain[0]} calls)")
    check(not any(packs[1:]) and not any(folds[1:]),
          f"{what}: no K2 pack or K1 fold after the first request: {packs}, {folds}")
    check(sum(k2_calls.values()) * len(requests) == sum(conv_fused.LAUNCHES.values()),
          f"{what}: the recorded K2 calls are the serving run's")
    k1_per_request = sum(c for c, _ in k1_calls.values())
    check(launches["mbconv_nhwc_pass1"] == launches["mbconv_nhwc_pass2"]
          == k1_per_request * len(requests), f"{what}: the recorded K1 calls are the serving run's")
    return dict(k2_calls=k2_calls, k1_calls=k1_calls, k1_inputs=k1_inputs, packs=packs,
                folds=folds, forwards=forwards, wall_ms=walls, span_ms=spans, masks=masks,
                runs=runs, launches=launches, peak=torch.cuda.max_memory_allocated())


def print_k2(r: dict, prefix: str = "") -> None:
    """One line of a `k2_row` row."""
    mma = "" if r["mma_ms"] is None else f", mma.sync kernel {r['mma_ms']:.4f} ms"
    if r["tile"]:
        mma += f"; tile {r['tile']}, {r['l2_read_bytes'] / 1e6:.1f} MB read from L2"
    print(f"{prefix}K2 {r['variant']} {r['shape']}: rel err {r['rel_err']:.3e} (tol 2e-2); "
          f"kernel {r['ms']:.4f} ms (unheld {r['wall_ms']:.4f}){mma}, plain (unheld) "
          f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f} (conv alone "
          f"{r['library_conv_ms']:.4f}), bound {r['bound_ms']:.4f} ({r['bound_by']})")


# the DeepLab encoder's dilated blocks (B4 stages 5-6 at output stride 16,
# dilation 2) run one kernel each a forward, and a request with TTA runs
# three forwards
DILATED = "dw_dilated_bn_silu_nhwc"
DILATED_A_REQUEST = 30
# (mid width, kernel size, blocks a forward) of those blocks, and (images,
# stride-16 map) of a tiled 2048^2 request's three forwards
DILATED_BLOCKS = ((960, 5, 1), (1632, 5, 7), (1632, 3, 1), (2688, 3, 1))
DILATED_MAPS = ((75, 32), (25, 24), (25, 40))


def dilated_rows(dev) -> list:
    """`dw_dilated_bn_silu_nhwc` (bf16, channels_last, dilation 2) at each
    shape of a tiled request: `microtime.kernel_row` against its plain
    version (2e-2) and against the stock sequence it replaced (`F.pad`,
    cuDNN's grouped conv, eval BN and SiLU in bf16, which round twice more:
    5e-2), with the launches a request (`blocks`), the bytes (the input read
    and the output written once, the folded weights and the shift) and the
    operations (k*k multiply-adds, then the shift and the SiLU ~5) per
    call."""
    import torch
    import torch.nn.functional as F

    from enhanced_unet_tpu_torch.benchmarks.microtime import kernel_row
    from enhanced_unet_tpu_torch.ops.kernels.depthwise import (
        DwFolded,
        dw_dilated_bn_silu_nhwc,
        dw_dilated_bn_silu_nhwc_plain,
    )

    d, eps, rows = 2, 1e-3, []
    g = torch.Generator(device=dev).manual_seed(0)
    for n, hw in DILATED_MAPS:
        for c, k, blocks in DILATED_BLOCKS:
            x = (torch.randn(n, c, hw, hw, generator=g, device=dev) * 0.5).to(
                torch.bfloat16).contiguous(memory_format=torch.channels_last)
            w = torch.randn(c, 1, k, k, generator=g, device=dev) * 0.2
            scale = torch.rand(c, generator=g, device=dev) + 0.5
            shift = torch.randn(c, generator=g, device=dev) * 0.1
            p = DwFolded((w[:, 0] * scale[:, None, None]).to(torch.bfloat16)
                         .permute(1, 2, 0).contiguous(), shift)
            w16, pad = w.to(torch.bfloat16), d * (k // 2)
            # eval BN with running mean 0 and variance 1 - eps: y * scale + shift
            mean, var = torch.zeros_like(scale), torch.ones_like(scale) - eps

            def stock():
                y = F.conv2d(F.pad(x, [pad] * 4), w16, None, 1, 0, d, c)
                return F.silu(F.batch_norm(y, mean, var, scale, shift, False, 0.0, eps))

            row = kernel_row(DILATED, lambda: dw_dilated_bn_silu_nhwc(x, p, d),
                             lambda: dw_dilated_bn_silu_nhwc_plain(x, p, d), 2e-2,
                             library=stock, library_tol=5e-2)
            pixels = n * hw * hw
            row.update(shape=f"[{n},{c},{hw},{hw}] k{k}", blocks=blocks,
                       bytes=2 * 2 * pixels * c + 2 * k * k * c + 4 * c,
                       ops=pixels * c * (2 * k * k + 5))
            rows.append(row)
            del x, p, w16
    return rows

# SegFormer-B5's Mix-FFN depthwise (`dw3x3_bias_gelu_nhwc`): (channels, blocks
# a forward) of its four stages (4x the stage's width, at strides 4 to 32),
# and (images, tile) of a tiled 2048^2 request's three forwards
MIXFFN = "dw3x3_bias_gelu_nhwc"
MIXFFN_A_REQUEST = 156
MIXFFN_STAGES = ((256, 3), (512, 6), (1280, 40), (2048, 3))
MIXFFN_FORWARDS = ((75, 512), (25, 384), (25, 640))


def mixffn_rows(dev) -> list:
    """`dw3x3_bias_gelu_nhwc` (bf16, channels_last) at each shape of a tiled
    SegFormer-B5 request: `microtime.kernel_row` against its plain version
    (2e-2) and against the stock sequence (cuDNN's depthwise conv with its
    bias, then the exact GELU, in bf16, which rounds once more: 5e-2), with
    the launches a request (`blocks`), the bytes (the input read and the
    output written once, the weights and the shift) and the operations
    (2 * 9 multiply-adds, then the shift and the GELU ~6) per call."""
    import torch
    import torch.nn.functional as F

    from enhanced_unet_tpu_torch.benchmarks.microtime import kernel_row
    from enhanced_unet_tpu_torch.ops.kernels.depthwise import (
        dw3x3_bias_gelu_nhwc,
        dw3x3_bias_gelu_nhwc_plain,
        fold_dw_bias,
    )

    rows = []
    g = torch.Generator(device=dev).manual_seed(0)
    for n, tile in MIXFFN_FORWARDS:
        for i, (c, blocks) in enumerate(MIXFFN_STAGES):
            hw = tile // (4 << i)
            x = (torch.randn(n, c, hw, hw, generator=g, device=dev) * 0.5).to(
                torch.bfloat16).contiguous(memory_format=torch.channels_last)
            w = torch.randn(c, 1, 3, 3, generator=g, device=dev) * 0.2
            b = torch.randn(c, generator=g, device=dev) * 0.1
            p = fold_dw_bias(w, b, torch.bfloat16)
            w16, b16 = w.to(torch.bfloat16), b.to(torch.bfloat16)

            def stock():
                return F.gelu(F.conv2d(x, w16, b16, 1, 1, 1, c))

            row = kernel_row(MIXFFN, lambda: dw3x3_bias_gelu_nhwc(x, p),
                             lambda: dw3x3_bias_gelu_nhwc_plain(x, p), 2e-2,
                             library=stock, library_tol=5e-2)
            pixels = n * hw * hw
            row.update(shape=f"[{n},{c},{hw},{hw}]", blocks=blocks,
                       bytes=2 * 2 * pixels * c + 2 * 9 * c + 4 * c,
                       ops=pixels * c * (2 * 9 + 6))
            rows.append(row)
            del x, p
    return rows


# the UNet++ decoder's 21 scSE calls a forward on the B5/B4 flagship
# (`scse_parts`): (part widths, whether the first is the node below read
# through a nearest 2x upsample, the output map's stride); the ten inner
# nodes' attention1, then the eleven nodes' attention2.  A tiled request's
# three forwards run them on `MIXFFN_FORWARDS`' batches and tiles.
SCSE = "scse_parts"
SCSE_CALLS = (
    ((512, 176), True, 16), ((176, 64), True, 8), ((64, 40), True, 4), ((40, 48), True, 2),
    ((256, 64, 64), True, 8), ((64, 40, 40), True, 4), ((40, 48, 48), True, 2),
    ((128, 40, 40, 40), True, 4), ((40, 48, 48, 48), True, 2),
    ((64, 48, 48, 48, 48), True, 2),
    ((256,), False, 16), ((64,), False, 8), ((40,), False, 4), ((48,), False, 2),
    ((128,), False, 8), ((40,), False, 4), ((48,), False, 2), ((64,), False, 4),
    ((48,), False, 2), ((32,), False, 2), ((16,), False, 1))
SCSE_A_REQUEST = 3 * len(SCSE_CALLS)
SCSE_GROUP = (("scse_parts (three kernels a call)", ("scse_",)),)


def scse_case(dev, n: int, tile: int, widths, up: bool, stride: int, g):
    """Seeded bf16 channels_last parts of one scSE call on `n` tiles of
    `tile`^2 (the first at half the map when `up`) and its block's folded
    weights (`init_random_weights_` on an `SCSEBlock` of the call's width)."""
    import torch

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


def scse_rows(dev) -> list:
    """`scse_parts` (bf16, channels_last) at each of a tiled 2048^2
    request's 63 calls (21 shapes of each forward): `microtime.kernel_row`
    against its plain version (2e-2) and against the stock sequence it
    replaced (the nearest upsample, `torch.cat`, then `SCSEBlock`'s stock
    calls, whose 1x1 convs round elsewhere: 5e-2), with the bytes (the
    parts read once, the upsampled one at its source size, the output
    written once), the bytes of this design (`design_bytes`: the parts read
    twice, for the means and for the gates) and the operations (per output
    element the sSE's multiply-add, two products and a sum, ~5; the cSE's
    are negligible) per call."""
    import torch

    from enhanced_unet_tpu_torch.benchmarks.microtime import kernel_row
    from enhanced_unet_tpu_torch.ops.kernels.scse import scse_parts, scse_parts_plain

    rows = []
    g = torch.Generator(device=dev).manual_seed(0)
    for n, tile in MIXFFN_FORWARDS:
        for widths, up, stride in SCSE_CALLS:
            parts, block = scse_case(dev, n, tile, widths, up, stride, g)
            w = block.fold()
            block.train()                       # the stock sequence of calls

            def stock():
                return block(*parts, up=up)

            row = kernel_row(SCSE, lambda: scse_parts(parts, up, w),
                             lambda: scse_parts_plain(parts, up, w), 2e-2,
                             library=stock, library_tol=5e-2)
            c, hw = sum(widths), tile // stride
            read = sum(t.numel() for t in parts)
            row.update(shape=f"[{n},{'+'.join(map(str, widths))},{hw},{hw}]"
                             + (" up" if up else ""), blocks=1,
                       bytes=2 * (read + n * c * hw * hw),
                       design_bytes=2 * (2 * read + n * c * hw * hw), ops=5 * n * c * hw * hw)
            rows.append(row)
            del parts, block, w
    return rows


def scse_entry(rows: list) -> dict:
    """Phase 3d: `scse_parts` over a tiled 2048^2 request on the B5/B4
    flagship from its rows at the request's 63 calls, which must beat the
    stock sequence over the request.  `bound_ms` is the function's bytes
    bound (the parts read once); `design_bound_ms` that of this three-launch
    design, which reads them twice.  Callable alone:
    `scse_entry(scse_rows(dev))`."""
    out = request_entry(
        SCSE, rows, SCSE_A_REQUEST,
        f"a tiled 2048^2 request's {SCSE_A_REQUEST} calls (the UNet++ decoder's 21 a forward "
        f"on [75,*,512,512], [25,*,384,384], [25,*,640,640]; bf16, channels_last)")
    out["design_bound_ms"], _ = bound(sum(r["design_bytes"] * r["blocks"] for r in rows), 0,
                                      "fp32")
    print(f"{SCSE}: design bound (the parts read twice) {out['design_bound_ms']:.4f} ms, "
          f"{out['ms'] / out['design_bound_ms']:.2f} times")
    check(out["ms"] < out["library_ms"],
          f"{SCSE} beats the stock sequence over a request: {out['ms']} ms against "
          f"{out['library_ms']}")
    return out


def phase4h_segformer(card: str, counters, dev, **model_kwargs) -> dict:
    """4h. SegFormer-B5 at full size (`get_model("segformer_b5")`, bf16,
    seeded random weights; `model_kwargs` resize it for a rehearsal)
    served by a tiled `Evaluator` with TTA (tile 512, overlap 64, the whole
    grid in one chunk) on one seeded 2048x2048 micrograph: a warm-up
    request, then every count set to 0 and one more request.  A
    [2048,2048] uint8 mask in {0,1,2}; the Mix-FFN's depthwise kernel
    launched 156 times (52 blocks in each of the three forwards) and no
    other counted kernel; its plain version never called and its weights
    laid out 52 times in the warm-up and never after.  Returns the
    request's launches, wall ms and peak memory.  Callable alone from a
    driver that has built the kernels: `phase4h_segformer(card, (depthwise.
    LAUNCHES, conv_fused.LAUNCHES, mbconv.LAUNCHES), torch.device("cuda"))`."""
    import numpy as np
    import torch

    from enhanced_unet_tpu_torch.models import get_model, segformer
    from enhanced_unet_tpu_torch.ops.kernels import depthwise
    from enhanced_unet_tpu_torch.train.evaluator import Evaluator

    t0 = time.perf_counter()
    model = get_model("segformer_b5", device=dev, seed=0, **model_kwargs)
    blocks = sum(model_kwargs.get("depths", (3, 6, 40, 3)))
    ev = Evaluator(model, "segformer_b5", enable_tta=True, device=dev, tiled=True, tile=TILE,
                   overlap=TILE_OVERLAP, verbose=False)
    micrograph = synthetic_images(1, TILED_SIZE, 21)[0]
    plain_fn, fold_fn = depthwise.dw3x3_bias_gelu_nhwc_plain, segformer.fold_dw_bias
    plain, folds = [0], []

    def counted_plain(*args):
        plain[0] += 1
        return plain_fn(*args)

    def counted_fold(*args):
        folds[-1] += 1
        return fold_fn(*args)

    depthwise.dw3x3_bias_gelu_nhwc_plain, segformer.fold_dw_bias = counted_plain, counted_fold
    try:
        folds.append(0)
        ev.predict_semantic_mask(micrograph)            # the warm-up: folds, plans
        folds.append(0)
        reset(counters)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        mask = ev.predict_semantic_mask(micrograph)
        wall = 1e3 * (time.perf_counter() - t1)
        peak = torch.cuda.max_memory_allocated()
    finally:
        depthwise.dw3x3_bias_gelu_nhwc_plain, segformer.fold_dw_bias = plain_fn, fold_fn
    launches = {k: v for counter in counters for k, v in counter.items() if v}
    classes = [int((mask == c).sum()) for c in range(3)]
    print(f"[{card}] SegFormer-B5 tiled {TILED_SIZE}^2 request (tile {TILE}, overlap "
          f"{TILE_OVERLAP}, TTA): wall {wall:.1f} ms, peak memory {peak} bytes, launches "
          f"{json.dumps(launches)}, plain {MIXFFN} calls (both requests) {plain[0]}, folds "
          f"(warm-up, request) {folds}, classes {classes}; {time.perf_counter() - t0:.1f} s")
    check(mask.dtype == np.uint8 and mask.shape == (TILED_SIZE, TILED_SIZE)
          and sum(classes) == mask.size, f"a [{TILED_SIZE},{TILED_SIZE}] uint8 mask in {{0,1,2}}")
    check(launches == {MIXFFN: 3 * blocks},
          f"the SegFormer request launched {MIXFFN} {3 * blocks} times and nothing else: "
          f"{launches}")
    check(plain[0] == 0, f"the SegFormer request ran {MIXFFN}'s plain version {plain[0]} times")
    check(folds == [blocks, 0], f"the Mix-FFN weights laid out {blocks} times, then never: "
          f"{folds}")
    del ev, model
    torch.cuda.empty_cache()
    return {"launches": launches, "wall_ms": wall, "peak": peak}


def request_entry(name: str, rows: list, a_request: int, what: str) -> dict:
    """The entry of a kernel over a tiled request from its rows at each
    shape (`dilated_rows`, `mixffn_rows`): each shape printed, and the
    times and work summed over the request's launches (each row's times its
    `blocks`), which must number `a_request`."""
    for r in rows:
        b, kind = bound(r["bytes"], r["ops"], "fp32")
        print(f"{name} {r['shape']} bf16, {r['blocks']} a request: rel err "
              f"{r['rel_err']:.3e} (tol 2e-2), against the stock sequence "
              f"{r['library_rel_err']:.3e} (tol 5e-2); kernel {r['ms']:.4f} ms (unheld "
              f"{r['wall_ms']:.4f}), plain {r['plain_ms']:.4f}, stock sequence "
              f"{r['library_ms']:.4f}, bound {b:.4f} ({kind}), {r['ms'] / b:.2f} times")
    check(sum(r["blocks"] for r in rows) == a_request, f"{a_request} {name} launches a request")
    total = {key: sum(r[key] * r["blocks"] for r in rows)
             for key in ("ms", "wall_ms", "plain_ms", "library_ms", "bytes", "ops")}
    b, kind = bound(total["bytes"], total["ops"], "fp32")
    print(f"{name} {what}: kernel {total['ms']:.4f} ms (unheld {total['wall_ms']:.4f}), "
          f"plain {total['plain_ms']:.4f}, stock sequence {total['library_ms']:.4f}, bound "
          f"{b:.4f} ({kind}), {total['ms'] / b:.2f} times the bound")
    return dict(
        shape=what, max_abs_err=max(r["max_abs_err"] for r in rows), ms=total["ms"],
        wall_ms=total["wall_ms"], plain_ms=total["plain_ms"], bound_ms=b, bound_by=kind,
        library_ms=total["library_ms"],
        request_shapes=[{k: r[k] for k in ("shape", "blocks", "rel_err", "library_rel_err",
                                           "ms", "plain_ms", "library_ms")}
                        for r in rows])


def depthwise_entries(dilated: list, mixffn: list) -> dict:
    """Phase 3c: the channels_last depthwise kernel's two epilogues over a
    tiled 2048^2 request, from their rows: the DeepLab encoder's dilated
    blocks (SiLU, 30 launches on the B5/B4 flagship) and SegFormer-B5's
    Mix-FFN (GELU, 156 launches), which must beat the stock sequence over
    the request.  Callable alone: `depthwise_entries(dilated_rows(dev),
    mixffn_rows(dev))`."""
    out = {DILATED: request_entry(
        DILATED, dilated, DILATED_A_REQUEST,
        f"a tiled 2048^2 request's {DILATED_A_REQUEST} launches ([75,C,32,32], "
        f"[25,C,24,24], [25,C,40,40]; C 960 and 1632 k5, 1632 and 2688 k3; d2 bf16)"),
        MIXFFN: request_entry(
        MIXFFN, mixffn, MIXFFN_A_REQUEST,
        f"a tiled 2048^2 SegFormer-B5 request's {MIXFFN_A_REQUEST} launches (C 256, 512, "
        f"1280, 2048 at strides 4-32 of [75,*,512,512], [25,*,384,384], [25,*,640,640]; "
        f"k3 d1 bf16)")}
    check(out[MIXFFN]["ms"] < out[MIXFFN]["library_ms"],
          f"{MIXFFN} beats the stock sequence over a request: {out[MIXFFN]['ms']} ms against "
          f"{out[MIXFFN]['library_ms']}")
    return out


ZOO = ("segnet", "unet", "unet_basic", "enhanced_unet_basic", "fcn", "fcn_basic",
       "pspnet", "pspnet_basic", "linknet", "linknet_basic")
# K2 launches a forward (the 3x3 stride-1 ConvBNActs of each flax tree, the
# stride-2 first blocks of ResNet stages 2-4 left out), and whether the
# first of them takes 3 channels (the small-Cin kernel)
ZOO_K2 = {"segnet": 15, "unet": 23, "unet_basic": 14, "enhanced_unet_basic": 15,
          "fcn": 18, "fcn_basic": 8, "pspnet": 24, "pspnet_basic": 4, "linknet": 7,
          "linknet_basic": 5}
ZOO_SMALLC = {"segnet": 1, "unet": 0, "unet_basic": 1, "enhanced_unet_basic": 2,
              "fcn": 0, "fcn_basic": 1, "pspnet": 0, "pspnet_basic": 1, "linknet": 0,
              "linknet_basic": 1}
ZOO_TRAIN_SIZE = 256              # phase 9's train steps: 2 x 256^2 (6a covers 640^2)
# phase 9's cross-check: the least share of pixels whose class (largest
# logit) the bf16 card and the fp32 CPU agree on, and the largest share of
# a SegNet pool's windows whose argmax the fp32 CPU decides otherwise; set
# from phase 9's readings on the H100 (PERF.md, section 6)
ZOO_AGREE, ZOO_POOL_FLIPS = 0.99, 0.05


def phase9_zoo(card: str, counters, dev, tmp: str, data_dir: str, k2_row, covered) -> dict:
    """9. The rest of the zoo on the card (see the module docstring).
    `k2_row` times K2 at a shape; `covered` holds phase 4's K2 shapes.
    Returns {model: {K2 entry: launches per request}}."""
    import dataclasses
    import os

    import torch

    from enhanced_unet_tpu_torch.config import get_preset
    from enhanced_unet_tpu_torch.data.dataset import CellDataset
    from enhanced_unet_tpu_torch.models import get_model
    from enhanced_unet_tpu_torch.models import segnet as segnet_module
    from enhanced_unet_tpu_torch.ops.kernels import conv_fused
    from enhanced_unet_tpu_torch.train import api
    from enhanced_unet_tpu_torch.train.evaluator import Evaluator
    from enhanced_unet_tpu_torch.train.trainer import create_train_state, make_train_step

    t_phase = time.perf_counter()
    requests = [synthetic_images(2, 512, seed) for seed in range(3)]    # phase 4's
    x_cross = torch.from_numpy(synthetic_images(1, 256, 7)) - 0.5       # phase 5's
    imgs, masks, valid = (torch.from_numpy(a).to(dev)
                          for a in blob_batch(2, ZOO_TRAIN_SIZE, ZOO_TRAIN_SIZE, 13))
    real_plain = conv_fused.fused_conv3x3_bn_relu_plain
    plain = [0]

    def counted_plain(*a, **kw):
        plain[0] += 1
        return real_plain(*a, **kw)

    zoo_launches, shapes = {}, {}
    for name in ZOO:
        torch.cuda.empty_cache()
        cfg = get_preset(name)
        t0 = time.perf_counter()
        model = get_model(name, seed=0)                  # device None: the card
        build_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        ev = Evaluator(model, name, enable_tta=cfg.enable_tta, verbose=False)
        forwards = 3 if cfg.enable_tta else 1
        served = serve_counted(ev, requests, counters, name)
        launches, walls, spans = served["launches"], served["wall_ms"], served["span_ms"]
        k2 = {k: launches[k] // len(requests) for k in conv_fused.LAUNCHES}
        zoo_launches[name] = k2
        print(f"[{card}] zoo {name} bf16, {n_params} parameters (built in {build_s:.2f} s), "
              f"{'TTA' if cfg.enable_tta else 'no TTA'}: 3 requests of 2 x 512^2, wall ms "
              f"{[round(v, 1) for v in walls]}, CUDA-event span ms "
              f"{[round(v, 1) for v in spans]}, peak memory {served['peak']} bytes, K2 launches "
              f"per request {json.dumps({k: v for k, v in k2.items() if v})}, packs per "
              f"request {served['packs']}, forwards {served['forwards'][-1]}")
        check(all(len(f) == forwards for f in served["forwards"]),
              f"{name}: {forwards} forwards a request")
        check(served["packs"][0] > 0, f"{name}: K2 weight packs on the first request")
        check(k2["conv3x3_bn_act_wgmma"] > 0, f"{name} launched K2's wgmma kernel")
        check(k2["conv3x3_bn_act_smallc"] == ZOO_SMALLC[name] * forwards,
              f"{name}: small-Cin launches {k2['conv3x3_bn_act_smallc']}")
        check(k2["conv3x3_bn_act_wgmma"] + k2["conv3x3_bn_act_smallc"]
              == ZOO_K2[name] * forwards, f"{name}: K2 launches per request {k2}")
        others = {k: v for k, v in launches.items()
                  if v and k not in ("conv3x3_bn_act_wgmma", "conv3x3_bn_act_smallc")}
        check(not others, f"{name} launched no other kernel ({others})")
        for key, count in served["k2_calls"].items():
            shapes.setdefault(key, {})[name] = count

        # cross-check: one 256^2 image, bf16 on the card against fp32 on the
        # CPU through the plain path, the same weights: the logits within
        # 5e-2 of max |logit| and the class of each pixel's largest logit
        # the same on ZOO_AGREE of the pixels.  SegNet's pools are
        # decisions: a bf16 rounding can move a window's argmax, and the
        # unpool then carries the value to another pixel.  So for SegNet the
        # logits are held against a second CPU forward that replays the
        # card's pool indices (the arithmetic alone), each pool's share of
        # windows that the fp32 CPU decides otherwise is held under
        # ZOO_POOL_FLIPS (wrong or garbage indices on the card move far
        # more), and the classes against the CPU's own decisions
        pools, flips = [], []
        real_pool = segnet_module.max_pool_with_indices

        def recording_pool(x):
            out = real_pool(x)
            pools.append(out[1])
            return out

        def replaying_pool(x):
            own, idx = real_pool(x)[1], pools[len(flips)].cpu()
            flips.append((own != idx).float().mean().item())
            n, c, h, w = x.shape
            xr = x.reshape(n, c, h // 2, 2, w // 2, 2).permute(0, 1, 2, 4, 3, 5)
            return xr.reshape(n, c, h // 2, w // 2, 4).gather(-1, idx[..., None])[..., 0], idx

        with torch.no_grad():
            segnet_module.max_pool_with_indices = recording_pool
            try:
                got, _ = model(x_cross.to(dev))
            finally:
                segnet_module.max_pool_with_indices = real_pool
            got = got.float().cpu()
            ref = get_model(name, dtype=torch.float32, device="cpu", seed=0)
            t0 = time.perf_counter()
            want, _ = ref(x_cross)
            cpu_s = time.perf_counter() - t0
            arith = want
            if pools:
                segnet_module.max_pool_with_indices = replaying_pool
                try:
                    arith, _ = ref(x_cross)
                finally:
                    segnet_module.max_pool_with_indices = real_pool
        del ref
        err = (got - arith).abs().max().item()
        scale = arith.abs().max().item()
        classes = want.argmax(-1)
        agree = (got.argmax(-1) == classes).float().mean().item()
        top = torch.bincount(classes.flatten(), minlength=want.shape[-1]).max().item()
        print(f"[{card}] zoo {name} cross-check 256^2: bf16 card vs fp32 cpu max_abs_err "
              f"{err:.4e}, max |logit| {scale:.4e}, ratio {err / scale:.4e} (tol 5e-2); "
              f"classes agree on {agree:.5f} of pixels (tol {ZOO_AGREE}; the CPU's most "
              f"common class on {top / classes.numel():.5f}); cpu forward {cpu_s:.2f} s"
              + (f"; logits against the CPU replaying the card's {len(flips)} pools' indices, "
                 f"shares the fp32 CPU decides otherwise {[round(f, 5) for f in flips]} "
                 f"(tol {ZOO_POOL_FLIPS}), without the replay ratio "
                 f"{(got - want).abs().max().item() / want.abs().max().item():.4e}"
                 if flips else ""))
        check(torch.isfinite(got).all().item(), f"{name}: finite cross-check logits")
        check(err <= 5e-2 * scale, f"{name}: bf16 card within 5e-2 of max |logit|")
        check(agree >= ZOO_AGREE, f"{name}: classes agree on {agree} of pixels")
        check(len(flips) == len(pools) and all(f <= ZOO_POOL_FLIPS for f in flips),
              f"{name}: pool index shares the CPU decides otherwise {flips}")

        # train steps: 1 warm, 2 timed, on 2 x 256^2 blob micrographs
        state = create_train_state(model, cfg, STEPS_PER_EPOCH)
        step = make_train_step(cfg)
        gen = torch.Generator(device=dev).manual_seed(0)
        params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        stats0 = {n: b.clone() for n, b in model.named_buffers() if "running" in n}
        reset(counters)
        torch.cuda.reset_peak_memory_stats()
        step_ms, losses = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, imgs, masks, valid, gen)
            losses.append(m["loss"].item())
            step_ms.append(1e3 * (time.perf_counter() - t0))
        train_peak = torch.cuda.max_memory_allocated()
        train_launches = {k: v for c in counters for k, v in c.items() if v}
        moved = all(not torch.equal(p, params0[n]) for n, p in model.named_parameters())
        stats_moved = all(not torch.equal(b, stats0[n]) for n, b in model.named_buffers()
                          if n in stats0)
        print(f"[{card}] zoo {name} train steps (1 warm + 2) at 2 x {ZOO_TRAIN_SIZE}^2: wall ms "
              f"{[round(v, 1) for v in step_ms]}, losses {[round(v, 4) for v in losses]}, "
              f"peak memory {train_peak} bytes, launches {train_launches}")
        check(all(math.isfinite(v) for v in losses), f"{name}: finite losses {losses}")
        check(moved and stats_moved, f"{name}: every parameter and running statistic changed")
        check(not train_launches, f"{name}: training launched no K1 or K2 kernel")
        del model, ev, state, params0, stats0, got, want, arith

    # K2 at the zoo's shapes that phase 4 did not give it
    t0 = time.perf_counter()
    rows = []
    for (shape, relu), users in sorted(shapes.items()):
        if (shape, relu) in covered:
            continue
        r = k2_row(shape[:5], relu)
        r["users"] = users                       # model -> launches per request
        rows.append(r)
        print_k2(r, f"[{card}] zoo, relu={relu}, launches per request {users}: ")
    check(rows and all(r["variant"] in ("wgmma", "smallc") for r in rows),
          "every zoo shape reaches the wgmma or the small-Cin kernel")
    for name in ZOO:
        mine = [(r, r["users"][name]) for r in rows if name in r["users"]]
        per = {k: sum(c * r[k] for r, c in mine)
               for k in ("ms", "wall_ms", "bound_ms", "mma_ms", "library_ms",
                         "library_conv_ms", "plain_ms")}
        print(f"[{card}] K2 per request of {name} over its {len(mine)} shapes that phase 4 "
              f"did not give (sum of launches x time): kernel {per['ms']:.4f} ms (unheld "
              f"{per['wall_ms']:.4f}), bound {per['bound_ms']:.4f}, mma.sync kernel "
              f"{per['mma_ms']:.4f}, cuDNN + epilogue {per['library_ms']:.4f}, cuDNN conv "
              f"alone {per['library_conv_ms']:.4f}, plain {per['plain_ms']:.4f}")
    print(f"[{card}] K2 at {len(rows)} zoo shapes: {time.perf_counter() - t0:.1f} s")

    # the entry points for unet on phase 7's folder: train_model (1 epoch,
    # the full-Evaluator gate), then predict_model batched on its best_model
    cfg = dataclasses.replace(get_preset("unet", num_epochs=1, data_dir=data_dir),
                              num_epochs=1, eval_every_epochs=1)
    conv_fused.fused_conv3x3_bn_relu_plain = counted_plain
    plain[0] = 0
    try:
        reset(counters)
        t0 = time.perf_counter()
        best = api.train_model("unet", data_dir, 1, checkpoint_dir=os.path.join(tmp, "zoo_ck"),
                               max_size=ENTRY_MAX_SIZE, cfg=cfg, log=lambda *a: None)
        train_s = time.perf_counter() - t0
        gate = {k: v for k, v in conv_fused.LAUNCHES.items() if v}
        check(gate.get("conv3x3_bn_act_wgmma", 0) > 0, f"unet's gate launched K2 ({gate})")
        test_dir = os.path.join(tmp, "zoo_test_images")
        os.makedirs(test_dir)
        names = CellDataset(data_dir, "test").files
        for n in names:
            os.link(os.path.join(data_dir, n), os.path.join(test_dir, n))
        reset(counters)
        t0 = time.perf_counter()
        out = api.predict_model("unet", test_dir, best,
                                results_dir=os.path.join(tmp, "zoo_predict"),
                                max_size=ENTRY_MAX_SIZE, log=lambda *a: None)
        predict_s = time.perf_counter() - t0
        pred = {k: v for c in counters for k, v in c.items() if v}
    finally:
        conv_fused.fused_conv3x3_bn_relu_plain = real_plain
    rows_out = out["predictions"]
    print(f"[{card}] zoo unet entry points on phase 7's folder: train_model 1 epoch + gate "
          f"{train_s:.2f} s (gate launches {gate}); predict_model batched over "
          f"{len(names)} micrographs {predict_s:.2f} s, launches {pred}, plain-version calls "
          f"{plain[0]}; rows {json.dumps(rows_out)}")
    check([r["filename"] for r in rows_out] == names, "predict_model wrote a row per micrograph")
    check(pred.get("conv3x3_bn_act_wgmma", 0) > 0 and set(pred) <= {
        "conv3x3_bn_act_wgmma", "conv3x3_bn_act_smallc"},
        f"predict_model launched K2 and nothing else ({pred})")
    check(plain[0] == 0, "the zoo's entry points ran no plain version of K2")
    print(f"[{card}] phase 9 (the zoo): {time.perf_counter() - t_phase:.1f} s")
    return zoo_launches


CLI_MODELS = ("enhanced_unet", "unet")   # phase 9b (a): the CLI's models
DP_STEPS = 3                             # phase 9b (b): train steps a path
RANK_STEPS = 2                           # phase 9b (c): train steps a rank


def recording_mesh(mesh, local: list, reduce_ms: list):
    """`mesh`, recording into `local` this rank's loss before each reduction
    (the one 0-d tensor reduced) and into `reduce_ms` the reduction's wall
    ms, synchronised before and after."""
    import torch

    from enhanced_unet_tpu_torch.parallel import Mesh

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    class RecordingMesh(Mesh):
        def all_mean_(self, tensors):
            local.append(next(t for t in tensors if t.dim() == 0).item())
            sync()
            t0 = time.perf_counter()
            super().all_mean_(tensors)
            sync()
            reduce_ms.append(1e3 * (time.perf_counter() - t0))

    return RecordingMesh(**vars(mesh))


def two_rank_steps(mesh, out_dir: str, size: int, pad: int) -> None:
    """9b (c), one of two ranks sharing the card over gloo: the flagship
    (full width, bf16) replicated from rank 0, then
    RANK_STEPS data-parallel train steps on this rank's own 2 x `pad`^2
    batch.  Writes the final state dict, the reported and the local (pre-
    reduction) losses, and the wall ms of each step, of each reduction and
    of the replication, to `out_dir/rank<r>.pt`."""
    import os

    import torch

    from enhanced_unet_tpu_torch.config import get_preset
    from enhanced_unet_tpu_torch.models import get_model
    from enhanced_unet_tpu_torch.parallel import replica_seed, replicate_state
    from enhanced_unet_tpu_torch.train.trainer import create_train_state, make_train_step

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    local, reduce_ms = [], []
    mesh = recording_mesh(mesh, local, reduce_ms)
    cfg = get_preset("enhanced_unet")
    model = get_model("enhanced_unet", seed=mesh.rank, device=mesh.device)
    state = create_train_state(model, cfg, STEPS_PER_EPOCH, device=mesh.device)
    sync()
    t0 = time.perf_counter()
    state = replicate_state(state, mesh)      # the ranks were seeded apart
    sync()
    replicate_ms = 1e3 * (time.perf_counter() - t0)
    imgs, masks, valid = (torch.from_numpy(a).to(mesh.device)
                          for a in blob_batch(2, size, pad, 21 + mesh.rank))
    gen = torch.Generator(device=mesh.device).manual_seed(replica_seed(1, mesh))
    step = make_train_step(cfg, mesh)
    losses, step_ms = [], []
    for _ in range(RANK_STEPS):
        sync()
        t0 = time.perf_counter()
        state, out = step(state, imgs, masks, valid, gen)
        losses.append(out["loss"].item())
        step_ms.append(1e3 * (time.perf_counter() - t0))
    torch.save({"state": {k: v.cpu() for k, v in model.state_dict().items()},
                "losses": losses, "local": local, "step_ms": step_ms, "reduce_ms": reduce_ms,
                "replicate_ms": replicate_ms, "device": str(mesh.device)},
               os.path.join(out_dir, f"rank{mesh.rank}.pt"))


def phase9b_cli_and_data_axis(card: str, counters, dev, tmp: str, data_dir: str) -> dict:
    """9b. The CLI and the data axis on the card, in phase 7's temporary
    directory and folder of micrographs (see the module docstring).
    Returns the readings."""
    import contextlib
    import csv
    import io
    import os

    import numpy as np
    import torch

    from enhanced_unet_tpu_torch import cli
    from enhanced_unet_tpu_torch.config import get_preset
    from enhanced_unet_tpu_torch.convert.pretrained import required_weights
    from enhanced_unet_tpu_torch.data.dataset import CellDataset
    from enhanced_unet_tpu_torch.models import get_model
    from enhanced_unet_tpu_torch.ops.kernels import conv_fused, mbconv
    from enhanced_unet_tpu_torch.ops.tiling import tile_grid, tiled_inference
    from enhanced_unet_tpu_torch.parallel import make_mesh, spawn, tiled_inference_sharded
    from enhanced_unet_tpu_torch.train.trainer import create_train_state, make_train_step

    t_phase = time.perf_counter()
    out = {"card": card}
    try:
        import matplotlib  # noqa: F401
        figures = True
    except ImportError as err:
        figures = False
        print(f"[{card}] phase 9b: matplotlib does not import ({err}): the CLI's figures "
              "are not rendered and not checked, and --mode visualize is not run")

    # ---- (a) the CLI, in-process, on phase 7's folder
    work = os.path.join(tmp, "cli")
    test_dir = os.path.join(work, "test_images")
    os.makedirs(test_dir)
    for name in CellDataset(data_dir, "test").files:
        os.link(os.path.join(data_dir, name), os.path.join(test_dir, name))
    def call(argv, what):
        reset(counters)
        plain.update(conv3x3_bn_act=0, mbconv=0)
        t0 = time.perf_counter()
        stdout = io.StringIO()
        try:
            with contextlib.redirect_stdout(stdout):
                rc = cli.main(argv, device=dev)
        finally:
            tail = stdout.getvalue().splitlines()[-12:]
            print(f"[{card}] cli {what}, the last lines it printed:\n  " + "\n  ".join(tail))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: v for c in counters for k, v in c.items() if v}
        check(rc == 0, f"the CLI's {what} returned 0 ({rc})")
        print(f"[{card}] cli {what}: {seconds:.2f} s, launches {json.dumps(launches)}, "
              f"plain-version calls {plain}")
        out.setdefault("cli_s", {})[what] = seconds
        return launches, stdout.getvalue()

    def k1_k2(launches, what):
        check(launches.get("mbconv_nhwc_pass1", 0) > 0
              and launches.get("mbconv_nhwc_pass2", 0) > 0, f"{what} launched K1")
        check(launches.get("conv3x3_bn_act_wgmma", 0)
              + launches.get("conv3x3_bn_act_smallc", 0) > 0, f"{what} launched K2")
        check(plain == {"conv3x3_bn_act": 0, "mbconv": 0},
              f"{what} ran no plain version of K1 or K2 ({plain})")

    def results_of(results_dir):
        with open(os.path.join(results_dir, "evaluation_results.json")) as f:
            results = json.load(f)
        check(list(results) == list(CLI_MODELS), f"a row per model ({list(results)})")
        for name, r in results.items():
            # the zeros of an isolated failure have neither these keys nor a
            # background IoU; sem_mean_iou (live and dead) may be 0 after one
            # epoch from seeded weights
            check({"sem_background_iou", "gt_live_count"} <= set(r)
                  and r["sem_background_iou"] > 0, f"{name} was evaluated, not isolated")
            check(all(math.isfinite(v) for v in r.values() if isinstance(v, (int, float))),
                  f"{name}'s metrics are finite")
        return results

    models = list(CLI_MODELS)
    base = ["--data-dir", data_dir, "--max-size", str(ENTRY_MAX_SIZE), "--models", *models]
    cwd = os.getcwd()
    os.chdir(work)       # the CLI's default checkpoint and results folders
    plain, restore = count_plain()
    try:
        launches, _ = call(["--mode", "train_eval", "--epochs", "1", *base,
                            "--results-dir", "results"], "train_eval")
        k1_k2(launches, "the CLI's train_eval")
        results = results_of("results")
        with open(os.path.join("results", "evaluation_results.csv"), encoding="utf-8-sig",
                  newline="") as f:
            rows = list(csv.reader(f))
        check(rows[0] == [c for c, _ in cli.CSV_COLUMNS], "the CSV header is CSV_COLUMNS")
        check([r[0] for r in rows[1:]] == models, "the CSV has a row per model")
        for name in models:
            check(os.path.isdir(os.path.join("checkpoints", name, "best_model")),
                  f"train_eval wrote {name}'s best_model")
        pngs = sorted(f for f in os.listdir("results") if f.endswith(".png"))
        if figures:
            check("model_comparison.png" in pngs, "the comparison figures were written")
        else:
            print(f"[{card}] cli train_eval: comparison figures not rendered (no "
                  f"matplotlib); PNGs in results/: {pngs}")
        out["cli_results"] = {n: {k: results[n][k] for k in ("sem_mean_iou", "sem_background_iou")}
                              for n in models}

        launches, _ = call(["--mode", "predict", "--tiled", "--data-dir", test_dir,
                            "--max-size", "2048", "--models", *models,
                            "--results-dir", "predict"], "predict --tiled")
        k1_k2(launches, "the CLI's predict --tiled")
        for name in models:
            with open(os.path.join("predict", name, "predictions", "predictions.csv")) as f:
                rows = list(csv.DictReader(f))
            check([r["filename"] for r in rows] == sorted(os.listdir(test_dir)),
                  f"predict wrote a row per micrograph for {name}")

        launches, _ = call(["--mode", "eval", "--eval-batch", "2", *base,
                            "--results-dir", "eval"], "eval --eval-batch 2")
        k1_k2(launches, "the CLI's eval --eval-batch 2")
        evaluated = results_of("eval")
        print(f"[{card}] cli sem_mean_iou: train_eval "
              f"{[results[n]['sem_mean_iou'] for n in models]}, eval --eval-batch 2 "
              f"{[evaluated[n]['sem_mean_iou'] for n in models]}")

        _, printed = call(["--mode", "manifest", "--models", *models], "manifest")
        want = "".join(
            f"{name}: {variant}  file={e['file']}  sha256[:8]={e['sha256_prefix']}\n"
            f"  url={e['url']}\n"
            for name in models for variant, e in required_weights(name).items())
        check(printed == want, "manifest printed the weight files of the models")

        if figures:
            call(["--mode", "visualize", *base, "--results-dir", "results"], "visualize")
        else:
            print(f"[{card}] cli visualize: skipped (no matplotlib)")
    finally:
        restore()
        os.chdir(cwd)

    # ---- (b) the data-parallel step at world size 1 (NCCL) against the plain step
    size, pad = TRAIN_SIZE, TRAIN_PAD

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    if dev.type == "cuda":
        torch.cuda.empty_cache()
    mesh = make_mesh(1, init_dir=os.path.join(tmp, "cli"),
                     device=None if dev.type == "cuda" else dev)
    try:
        cfg = get_preset("enhanced_unet")
        model = get_model("enhanced_unet", seed=0, device=dev)
        start = {k: v.clone() for k, v in model.state_dict().items()}
        imgs, masks, valid = (torch.from_numpy(a).to(dev) for a in blob_batch(2, size, pad, 11))
        names = [n for n, _ in model.named_parameters()]

        reduce_ms = []

        def run(with_mesh):
            """DP_STEPS steps from the same state and draws: the step wall
            ms, the first step's clipped gradient and the update."""
            model.load_state_dict(start)
            state = create_train_state(model, cfg, STEPS_PER_EPOCH, device=dev)
            step = make_train_step(cfg, recording_mesh(mesh, [], reduce_ms) if with_mesh
                                   else None)
            gen = torch.Generator(device=dev).manual_seed(0)
            times = []
            for i in range(DP_STEPS):
                sync()
                t0 = time.perf_counter()
                state, _ = step(state, imgs, masks, valid, gen)
                sync()
                times.append(1e3 * (time.perf_counter() - t0))
                if i == 0:
                    grad = torch.cat([p.grad.reshape(-1).float()
                                      for p in model.parameters() if p.grad is not None])
            params = dict(model.named_parameters())
            update = torch.cat([(params[n].detach() - start[n]).reshape(-1).float()
                                for n in names])
            return grad, update, times

        def rel(a, b):
            return ((a.double() - b.double()).norm() / b.double().norm()).item()

        grad_a, upd_a, plain_ms = run(False)
        grad_d, upd_d, dp_ms = run(True)
        grad_b, upd_b, plain_ms_b = run(False)
        rels = {"grad": rel(grad_d, grad_a), "grad_plain": rel(grad_b, grad_a),
                "update": rel(upd_d, upd_a), "update_plain": rel(upd_b, upd_a)}
        del grad_a, grad_b, grad_d, upd_a, upd_b, upd_d
        plain_ms += plain_ms_b
        warm = float(np.median(dp_ms[1:])) - float(np.median(plain_ms[1:DP_STEPS]
                                                            + plain_ms[DP_STEPS + 1:]))
        print(f"[{card}] dp step, world size 1 over NCCL, 2 x {pad}^2, {DP_STEPS} steps a "
              f"path (plain, dp, plain): step wall ms dp {[round(t, 1) for t in dp_ms]}, "
              f"plain {[round(t, 1) for t in plain_ms]}; median dp - plain after the first "
              f"step {warm:.2f} ms; the reductions alone (synchronised around) "
              f"{[round(t, 2) for t in reduce_ms]} ms; the first step's clipped gradient rel "
              f"L2 dp vs plain {rels['grad']:.3e}, plain vs plain {rels['grad_plain']:.3e}; "
              f"the update after {DP_STEPS} steps dp vs plain {rels['update']:.3e}, plain "
              f"vs plain {rels['update_plain']:.3e} (AdamW's early steps are about lr x "
              f"sign(g): a gradient's noise flips whole steps)")
        check(math.isfinite(rels["grad"]) and rels["grad"] <= max(10 * rels["grad_plain"], 1e-5),
              "the dp step at world size 1 takes the plain step's gradient (within 10x the "
              "plain step's own run-to-run difference, or 1e-5)")
        out["dp"] = {"dp_ms": dp_ms, "plain_ms": plain_ms, "warm_difference_ms": warm,
                     "reduce_ms": reduce_ms, **rels}
        del model, start, imgs, masks, valid

        # ---- (d) tiled_inference_sharded at world size 1 against tiled_inference
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        serve = serving_model(device=dev).eval()
        image = torch.from_numpy(synthetic_images(1, TILED_SIZE, 17)[0]).to(dev)

        def apply_fn(tiles):
            return serve(tiles)[0]

        with torch.no_grad():
            plain, restore = count_plain()
            try:
                sharded_ms, single_ms = [], []
                for _ in range(2):                           # the first call, then warm
                    reset(counters)
                    plain.update(conv3x3_bn_act=0, mbconv=0)
                    sync()
                    t0 = time.perf_counter()
                    sharded = tiled_inference_sharded(apply_fn, image, mesh, tile=TILE,
                                                      overlap=TILE_OVERLAP)
                    sync()
                    sharded_ms.append(1e3 * (time.perf_counter() - t0))
                    launches = {k: v for c in counters for k, v in c.items() if v}
                    k1_k2(launches, "tiled_inference_sharded")
                    t0 = time.perf_counter()
                    single = tiled_inference(apply_fn, image, tile=TILE, overlap=TILE_OVERLAP)
                    sync()
                    single_ms.append(1e3 * (time.perf_counter() - t0))
            finally:
                restore()
        single = single.cpu()
        err = (sharded - single).abs().max().item()
        agree = (sharded.argmax(-1) == single.argmax(-1)).double().mean().item()
        n_tiles = len(tile_grid(TILED_SIZE, TILED_SIZE, TILE, TILE_OVERLAP)[2])
        print(f"[{card}] tiled_inference_sharded, world size 1, one {TILED_SIZE}^2 micrograph, "
              f"tile {TILE} overlap {TILE_OVERLAP} ({n_tiles} tiles in one forward, no TTA): "
              f"wall ms {[round(t, 1) for t in sharded_ms]} (first, warm), launches a call "
              f"{json.dumps(launches)}; one-device tiled_inference (batches of 8) "
              f"{[round(t, 1) for t in single_ms]}; max |prob diff| {err:.3e} "
              f"(tol 5e-2), pixels of the same class {agree:.6f} (tol 0.9999)")
        check(tuple(sharded.shape) == (TILED_SIZE, TILED_SIZE, 3)
              and bool(torch.isfinite(sharded).all()), "finite sharded probabilities")
        check(err <= 5e-2, "the sharded tiles' probabilities within 5e-2 of one device's")
        check(agree >= 0.9999, "the sharded tiles' classes agree on 0.9999 of pixels")
        out["tiled"] = {"sharded_ms": sharded_ms, "single_ms": single_ms, "err": err,
                        "agree": agree, "launches": launches}
        del serve, image
    finally:
        torch.distributed.destroy_process_group()

    # ---- (c) two ranks on the one card over gloo
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ranks_dir = os.path.join(tmp, "ranks")
    os.makedirs(ranks_dir)
    t0 = time.perf_counter()
    spawn(two_rank_steps, 2, (ranks_dir, size, pad),
          device="cuda:0" if dev.type == "cuda" else dev, backend="gloo",
          init_dir=ranks_dir, timeout=900)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(ranks_dir, f"rank{r}.pt")) for r in range(2)]
    a, b = ranks[0]["state"], ranks[1]["state"]
    unequal = [k for k in a if not torch.equal(a[k], b[k])]
    means = [(l0 + l1) / 2 for l0, l1 in zip(ranks[0]["local"], ranks[1]["local"])]
    print(f"[{card}] two processes sharing one card, gloo on {ranks[0]['device']} tensors, "
          f"2 x {pad}^2 each, {RANK_STEPS} steps (no multi-GPU figure): spawn to join "
          f"{spawn_s:.1f} s; replicate_state ms {[round(r['replicate_ms'], 1) for r in ranks]}; "
          f"step wall ms {[[round(t, 1) for t in r['step_ms']] for r in ranks]}; reduction "
          f"wall ms {[[round(t, 1) for t in r['reduce_ms']] for r in ranks]}; local losses "
          f"{[r['local'] for r in ranks]}, reported {[r['losses'] for r in ranks]}; tensors "
          f"unequal across the ranks {len(unequal)} of {len(a)}")
    check(not unequal, f"every parameter and running statistic bitwise equal ({unequal[:3]})")
    for r in ranks:
        check(all(abs(x - m) <= 1e-6 * abs(m) for x, m in zip(r["losses"], means)),
              "each rank's reported loss is the mean of the local losses")
    out["two_ranks"] = {"spawn_s": spawn_s, "step_ms": [r["step_ms"] for r in ranks],
                        "reduce_ms": [r["reduce_ms"] for r in ranks],
                        "replicate_ms": [r["replicate_ms"] for r in ranks]}
    print(f"[{card}] phase 9b (the CLI and the data axis): "
          f"{time.perf_counter() - t_phase:.1f} s")
    return out


SPATIAL_SIZES = (2048, 512)     # phase 9c: the micrograph; the small one where ASPP gathers
SPATIAL_TOL, SPATIAL_AGREE = 5e-2, 0.9999   # of max |logit|; pixels of the same class
SPATIAL_K2_ITERS = 10           # calls per timing of K2's rows at the spatial path's shapes


def spatial_runs(mesh, images: dict, repeats: dict):
    """The spatial entry points on this rank's bands of `images` (key ->
    [H, W, 3] on the host): the flagship (`serving_model`) through
    `make_spatial_apply` (keys starting "flagship"), BasicUNet (seed 0)
    through `make_spatial_basic_unet` ("basic_unet"), `repeats[key]` calls
    each (the first, then warm).  Returns per key the whole logits
    (gathered, on the host), each call's wall ms, the last call's launches
    and plain-version calls, this process's peak memory over the calls,
    and the last call's K2 calls through `models.blocks` (`k2_calls`:
    (input shape + Cout, relu) -> calls; the flagship's, BasicUNet's
    convolutions go through `parallel.spatial`) and K1 calls (`k1_calls`:
    (band shape, Cout, residual, rows, hw) -> calls); and the folded
    weights of the first K1 block of each (Cin, Cout, residual)
    (`k1_weights`, on the card)."""
    import torch

    from enhanced_unet_tpu_torch.models import blocks, encoders, get_model
    from enhanced_unet_tpu_torch.ops.kernels import conv_fused, depthwise, mbconv
    from enhanced_unet_tpu_torch.parallel.spatial import (
        gather_image_h, make_spatial_apply, make_spatial_basic_unet, shard_image_h)

    counters = (conv_fused.LAUNCHES, mbconv.LAUNCHES, depthwise.LAUNCHES)
    dev = mesh.device
    flagship = serving_model(device=dev).eval()
    unet = get_model("unet_basic", seed=0, device=dev)
    k2_entry, k1_entry = blocks.fused_conv3x3_bn_relu_packed, encoders.mbconv_infer_nchw
    k2_calls, k1_calls, k1_weights = {}, {}, {}

    def recording_k2(x, packed, relu=True):
        key = (tuple(x.shape) + (packed.cout,), relu)
        k2_calls[key] = k2_calls.get(key, 0) + 1
        return k2_entry(x, packed, relu)

    def recording_k1(x, p, *, residual, rows=None, reduce=None, hw=None):
        key = (tuple(x.shape), p.wproj.shape[1], residual, rows, hw)
        k1_calls[key] = k1_calls.get(key, 0) + 1
        k1_weights.setdefault((x.shape[1], p.wproj.shape[1], residual), p)
        return k1_entry(x, p, residual=residual, rows=rows, reduce=reduce, hw=hw)

    out = {}
    plain, restore = count_plain()
    blocks.fused_conv3x3_bn_relu_packed, encoders.mbconv_infer_nchw = recording_k2, recording_k1
    try:
        for key, image in images.items():
            basic = key == "basic_unet"
            fn = ((lambda b: make_spatial_basic_unet(mesh)(unet, b)) if basic else
                  (lambda b: make_spatial_apply(flagship, mesh)(b[None])[0]))
            band = shard_image_h(image, mesh)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            ms = []
            for _ in range(repeats[key]):
                reset(counters)
                plain.update(conv3x3_bn_act=0, mbconv=0)
                k2_calls.clear()
                k1_calls.clear()
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                y = fn(band)
                torch.cuda.synchronize(dev)
                ms.append(1e3 * (time.perf_counter() - t0))
            out[key] = {"ms": ms, "peak": torch.cuda.max_memory_allocated(dev),
                        "launches": {k: v for c in counters for k, v in c.items() if v},
                        "plain": dict(plain), "logits": gather_image_h(y, mesh).cpu(),
                        "k2_calls": dict(k2_calls), "k1_calls": dict(k1_calls)}
            del y, band
    finally:
        restore()
        blocks.fused_conv3x3_bn_relu_packed, encoders.mbconv_infer_nchw = k2_entry, k1_entry
    out["k1_weights"] = k1_weights
    return out


def spatial_two_ranks(mesh, out_dir: str):
    """9c (b), one of two ranks sharing the card over gloo: `spatial_runs`
    on the images `out_dir/images.pt`, two calls each; rank 0 writes what it returns
    (every rank gathers the same logits), every rank its times, launches,
    calls and peak memory."""
    import os

    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    images = torch.load(os.path.join(out_dir, "images.pt"))
    out = spatial_runs(mesh, images, {k: 2 for k in images})
    del out["k1_weights"]
    if mesh.rank:
        out = {k: {n: v for n, v in r.items() if n != "logits"} for k, r in out.items()}
    torch.save(out, os.path.join(out_dir, f"rank{mesh.rank}.pt"))


def spatial_k1_rows(card: str, dev, k1_keys: dict, k1_weights: dict):
    """9c (d): K1 at each band the spatial flagship gave it (`k1_keys`:
    (band shape, Cout, residual, rows, hw) -> (launches, run)).  Each band
    is cut as the path cuts it from a seeded whole map (one row of the
    neighbours' on either side, zeros beyond the image); on the `nhwc`
    kernels with the block's own folded weights (`k1_weights`), pass 1 with
    the band's window and pass 2 on the haloed band, and on the fp32
    row-streaming kernel with a seeded fp32 block, pass 1 alone; each
    against its plain version (bf16 within 2e-2 of max |value|, fp32 within
    1e-4) and the bands' sums against the whole map's; timed beside the
    plain version (and pass 1 beside the launch without its window) and the
    bound.  Returns the rows and the fp32 kernel's launches in this check."""
    import torch
    import torch.nn.functional as F

    from enhanced_unet_tpu_torch.benchmarks.microtime import device_ms
    from enhanced_unet_tpu_torch.models import init_random_weights_
    from enhanced_unet_tpu_torch.models.encoders import MBConvBlock
    from enhanced_unet_tpu_torch.ops.kernels import mbconv

    g = torch.Generator(device=dev).manual_seed(3)
    rows, fp32_launches = [], 0
    for key, (count, run) in k1_keys.items():
        (n, c, hb, w), cout, res, (lo, hi), hw = key
        hl = hi - lo
        nb = hw // (hl * w)
        check(lo == 1 and hb == hl + 2 and hw == nb * hl * w,
              f"K1 band {key}: its own rows [1, H - 1) of a map of {nb} bands")
        for dtype in (torch.bfloat16, torch.float32):
            bf16 = dtype == torch.bfloat16
            name = "mbconv_nhwc_pass1_window" if bf16 else "mbconv_pass1_window"
            if bf16:
                p = k1_weights[(c, cout, res)]
                pass1 = mbconv.mbconv_nhwc_pass1
                fmt = torch.channels_last
            else:
                p = init_random_weights_(MBConvBlock(c, cout, 1, 1, 3, fused=True,
                                                     dtype=dtype), 1).eval().to(dev).fold()
                pass1 = mbconv.mbconv_pass1
                fmt = torch.contiguous_format
            with torch.no_grad():
                whole = torch.randn(n, nb * hl, w, c, generator=g, device=dev).to(dtype)
                whole = whole.permute(0, 3, 1, 2).contiguous(memory_format=fmt)
                xp = F.pad(whole, (0, 0, 1, 1))
                bands = [xp[:, :, r * hl:(r + 1) * hl + 2].contiguous(memory_format=fmt)
                         for r in range(nb)]
                check(tuple(bands[0].shape) == (n, c, hb, w), f"K1 band {key} as the path cut it")
                before = mbconv.LAUNCHES[name]
                got = [pass1(b, p, (lo, hi)) for b in bands]
                torch.cuda.synchronize()
                check(mbconv.LAUNCHES[name] - before == nb, f"{name} launched once a band")
                fp32_launches += 0 if bf16 else nb
                want = [mbconv.mbconv_pass1_plain(b, p, (lo, hi)) for b in bands]
                err = max((a - b).abs().max().item() for a, b in zip(got, want))
                rel = err / max(b.abs().max().item() for b in want)
                whole_sums = mbconv.mbconv_pass1_plain(whole, p)
                total = ((sum(got) - whole_sums).abs().max().item()
                         / whole_sums.abs().max().item())
                tol = 2e-2 if bf16 else 1e-4
                kind = "bf16" if bf16 else "fp32"
                es = whole.element_size()
                w_bytes = c * (9 * es + 4)
                b1, by1 = bound(n * hb * w * c * es + w_bytes + n * c * 4,
                                n * hl * w * 24 * c, kind)
                shape = f"[{n},{c},{hb},{w}] rows [{lo},{hi}) of {nb} band(s) {kind}"
                row = dict(name=name, shape=shape, launches=count if bf16 else nb,
                           launches_from=run if bf16 else "this check", max_abs_err=err,
                           rel_err=rel, bands_sum_rel_err=total,
                           ms=device_ms(lambda: pass1(bands[0], p, (lo, hi)), K1_ITERS),
                           wall_ms=device_ms(lambda: pass1(bands[0], p, (lo, hi)), K1_ITERS,
                                             held=False),
                           unwindowed_ms=device_ms(lambda: pass1(bands[0], p), K1_ITERS),
                           plain_ms=device_ms(lambda: mbconv.mbconv_pass1_plain(
                               bands[0], p, (lo, hi)), K1_ITERS),
                           bound_ms=b1, bound_by=by1, library_ms=None)
                print(f"K1 {name} {shape}: rel err {rel:.3e} (tol {tol:g}), the bands' sums "
                      f"against the whole map's {total:.3e}; kernel {row['ms']:.4f} ms (unheld "
                      f"{row['wall_ms']:.4f}, without the window {row['unwindowed_ms']:.4f}), "
                      f"plain {row['plain_ms']:.4f}, bound {b1:.4f} ({by1}); launches "
                      f"{row['launches']} ({row['launches_from']})")
                check(rel <= tol, f"{name} {shape} within {tol} of its plain version")
                check(total <= tol, f"{name} {shape}: the bands' sums make the whole map's")
                rows.append(row)
                if bf16:               # pass 2 on the haloed band, the gate's sums all-reduced
                    wpp = mbconv.se_gated_projection(sum(want), p, hw, dtype)
                    x0 = bands[0]
                    y = mbconv.mbconv_nhwc_pass2(x0, p, wpp, res)
                    torch.cuda.synchronize()
                    y_want = mbconv.mbconv_pass2_plain(x0, p, wpp, res)
                    err2 = (y.float() - y_want.float()).abs().max().item()
                    rel2 = err2 / y_want.float().abs().max().item()
                    ops = n * hb * w * (23 * c + 2 * c * cout + 2 * cout)
                    b2, by2 = bound(n * hb * w * (c + cout) * es + w_bytes + n * c * cout * es
                                    + cout * 4, ops, kind)
                    shape2 = f"[{n},{c},{hb},{w}] ->{cout}{' residual' if res else ''} {kind}"
                    row2 = dict(name="mbconv_nhwc_pass2", shape=shape2, launches=count,
                                launches_from=run, max_abs_err=err2, rel_err=rel2,
                                ms=device_ms(lambda: mbconv.mbconv_nhwc_pass2(x0, p, wpp, res),
                                             K1_ITERS),
                                plain_ms=device_ms(lambda: mbconv.mbconv_pass2_plain(
                                    x0, p, wpp, res), K1_ITERS),
                                bound_ms=b2, bound_by=by2, library_ms=None)
                    print(f"K1 mbconv_nhwc_pass2 {shape2} (spatial band): rel err {rel2:.3e} "
                          f"(tol 2e-2); kernel {row2['ms']:.4f} ms, plain "
                          f"{row2['plain_ms']:.4f}, bound {b2:.4f} ({by2}); launches {count} "
                          f"({run})")
                    check(rel2 <= 2e-2, f"mbconv_nhwc_pass2 {shape2} within 2e-2 of its plain "
                          "version")
                    rows.append(row2)
                    del y, y_want, wpp
                del whole, xp, bands, got, want, whole_sums
    return rows, fp32_launches


def phase9c_spatial(card: str, dev, tmp: str, k2_row) -> dict:
    """9c. Spatial partitioning on the card (see the module docstring).
    Returns the readings, K2's and K1's rows at the spatial path's shapes
    and the windowed pass-1 kernels' entries and launches."""
    import os

    import torch

    from enhanced_unet_tpu_torch.models import get_model
    from enhanced_unet_tpu_torch.parallel import make_mesh, spawn

    t_phase = time.perf_counter()
    big, small = SPATIAL_SIZES
    images = {"flagship": torch.from_numpy(synthetic_images(1, big, 17)[0]),
              "flagship_small": torch.from_numpy(synthetic_images(1, small, 18)[0])}
    images["basic_unet"] = images["flagship"]

    # ---- one process: each model's own forward (the reference), the first
    # call and a warm one, its peak
    ref = {}
    flagship = serving_model(device=dev).eval()
    unet = get_model("unet_basic", seed=0, device=dev)
    for key, image in images.items():
        model = unet if key == "basic_unet" else flagship
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        with torch.no_grad():
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                y = model(image[None].to(dev))[0][0]
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
        ref[key] = {"ms": ms, "logits": y.float().cpu(),
                    "peak": torch.cuda.max_memory_allocated()}
        del y
    del flagship, unet

    def held(key, r, what):
        """The checks of one spatial run against the one-process forward."""
        logits, want = r["logits"], ref[key]["logits"]
        masks = logits.argmax(-1)
        err = (logits - want).abs().max().item() / want.abs().max().item()
        agree = (masks == want.argmax(-1)).double().mean().item()
        launches = r["launches"]
        k2 = launches.get("conv3x3_bn_act_wgmma", 0) + launches.get("conv3x3_bn_act_smallc", 0)
        print(f"[{card}] {what}: wall ms {[round(t, 1) for t in r['ms']]} (one process "
              f"{[round(t, 1) for t in ref[key]['ms']]}); peak {r['peak']} bytes (one process "
              f"{ref[key]['peak']}); launches "
              f"{json.dumps(launches)}; plain-version calls {r['plain']}; max |logit diff| / "
              f"max |logit| {err:.3e} (tol {SPATIAL_TOL:g}); pixels of the same class "
              f"{agree:.6f} (tol {SPATIAL_AGREE})")
        check(tuple(masks.shape) == tuple(want.shape[:2])
              and set(masks.unique().tolist()) <= {0, 1, 2}, f"{what}: masks in {{0,1,2}}")
        check(bool(torch.isfinite(logits).all()), f"{what}: finite logits")
        check(err <= SPATIAL_TOL, f"{what}: logits within {SPATIAL_TOL} of the one process's")
        check(agree >= SPATIAL_AGREE, f"{what}: classes agree on {SPATIAL_AGREE} of pixels")
        check(k2 > 0, f"{what}: K2 launched")
        check(r["plain"] == {"conv3x3_bn_act": 0, "mbconv": 0},
              f"{what}: no plain version of K1 or K2 ({r['plain']})")
        if key.startswith("flagship"):
            window = launches.get("mbconv_nhwc_pass1_window", 0)
            check(window > 0 and launches.get("mbconv_nhwc_pass2", 0) == window
                  and launches.get("mbconv_nhwc_pass1", 0) == 0,
                  f"{what}: K1's windowed nhwc pass 1 and its pass 2 launched, no "
                  "unwindowed pass 1")
            check(sum(r["k2_calls"].values()) == k2 and sum(r["k1_calls"].values()) == window,
                  f"{what}: the recorded K2 and K1 calls are the run's launches")
        other = {k: v for k, v in launches.items() if k not in (
            "conv3x3_bn_act_wgmma", "conv3x3_bn_act_smallc", "mbconv_nhwc_pass1_window",
            "mbconv_nhwc_pass2")}
        check(not other, f"{what}: no other kernel ({other})")
        return {"ms": r["ms"], "peak": r["peak"], "one_process_peak": ref[key]["peak"],
                "one_process_ms": ref[key]["ms"], "err": err, "agree": agree,
                "launches": launches}

    out = {"card": card}
    # ---- (a) world size 1 over NCCL
    os.makedirs(os.path.join(tmp, "spatial1"))
    mesh = make_mesh(1, "space", init_dir=os.path.join(tmp, "spatial1"))
    try:
        runs = spatial_runs(mesh, {k: images[k] for k in ("flagship", "basic_unet")},
                            {"flagship": 2, "basic_unet": 2})
    finally:
        torch.distributed.destroy_process_group()
    k1_weights = runs.pop("k1_weights")
    out["ws1"] = {key: held(key, r, f"spatial {key} {big}^2, world size 1 over NCCL")
                  for key, r in runs.items()}
    ws1 = runs["flagship"]
    k2_calls = ws1["k2_calls"]
    k1_keys = {k: (c, f"the {big}^2 flagship at world size 1") for k, c in ws1["k1_calls"].items()}
    del runs

    # ---- (b) two ranks sharing the card over gloo
    ranks_dir = os.path.join(tmp, "spatial2")
    os.makedirs(ranks_dir)
    torch.save(images, os.path.join(ranks_dir, "images.pt"))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    spawn(spatial_two_ranks, 2, (ranks_dir,), device="cuda:0", backend="gloo",
          init_dir=ranks_dir, timeout=600)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(ranks_dir, f"rank{r}.pt")) for r in range(2)]
    out["two_ranks"] = {}
    for key in images:
        size = images[key].shape[0]
        r = dict(ranks[0][key])
        r["ms"] = [ranks[q][key]["ms"] for q in range(2)]
        res = held(key, {**r, "ms": r["ms"][0]},
                   f"spatial {key} {size}^2, two ranks on one card over gloo, rank 0 "
                   f"(rank 1: wall ms {[round(t, 1) for t in r['ms'][1]]}, peak "
                   f"{ranks[1][key]['peak']} bytes, launches "
                   f"{json.dumps(ranks[1][key]['launches'])})")
        res["ms"], res["peak"] = r["ms"], [ranks[q][key]["peak"] for q in range(2)]
        out["two_ranks"][key] = res
        if key.startswith("flagship"):
            for k, c in r["k1_calls"].items():
                k1_keys.setdefault(k, (c, f"the {size}^2 flagship on two ranks, rank 0"))
    print(f"[{card}] two ranks: spawn to join {spawn_s:.1f} s")
    out["two_ranks_spawn_s"] = spawn_s

    # ---- (c) K2 at each shape the spatial flagship gave it at world size 1
    t0 = time.perf_counter()
    k2_rows = []
    for (shape, relu), count in sorted(k2_calls.items()):
        r = k2_row(shape[:5], relu, iters=SPATIAL_K2_ITERS)
        r["launches"] = count
        print_k2(r, "spatial ")
        k2_rows.append(r)
    check(all(r["variant"] in ("wgmma", "smallc") for r in k2_rows),
          "every spatial K2 shape reaches the wgmma or the small-Cin kernel")
    per_call = {k: sum(r["launches"] * r[k] for r in k2_rows)
                for k in ("ms", "wall_ms", "bound_ms", "library_ms", "library_conv_ms",
                          "plain_ms")}
    print(f"K2 per spatial flagship call at world size 1 ({len(k2_rows)} shapes, "
          f"{sum(k2_calls.values())} launches; sum of launches x time): kernel "
          f"{per_call['ms']:.4f} ms (unheld {per_call['wall_ms']:.4f}), bound "
          f"{per_call['bound_ms']:.4f}, cuDNN + epilogue {per_call['library_ms']:.4f}, cuDNN "
          f"conv alone {per_call['library_conv_ms']:.4f}, plain {per_call['plain_ms']:.4f}; "
          f"{time.perf_counter() - t0:.1f} s")

    # ---- (d) K1 at each band the spatial flagship gave it
    k1_rows, fp32_launches = spatial_k1_rows(card, dev, k1_keys, k1_weights)
    check(fp32_launches > 0, "the fp32 windowed pass 1 launched")
    first = {}
    for row in k1_rows:                  # the widest band at world size 1 leads
        first.setdefault(row["name"], row)
    out["entries"] = {k: first[k] for k in ("mbconv_nhwc_pass1_window", "mbconv_pass1_window")}
    out["launches"] = {"mbconv_nhwc_pass1_window": ws1["launches"]["mbconv_nhwc_pass1_window"],
                       "mbconv_pass1_window": fp32_launches}
    out["spatial_launches"] = ws1["launches"]
    out["k2_rows"], out["k2_per_call"], out["k1_rows"] = k2_rows, per_call, k1_rows
    print(f"[{card}] phase 9c (spatial partitioning): {time.perf_counter() - t_phase:.1f} s")
    return out


TP_HW, TP_BATCH = 512, 2        # phase 9d: the flagship on a seeded 2 x 512^2 batch
TP_MIN_CHANNELS = 128             # JAX's default: no weight of a stage-0 block is split
TP_TOL, TP_AGREE = 5e-2, 0.9999   # of max |logit|; pixels of the same class
TP_K2_ITERS = 10                  # calls per timing of K2's rows at the split shapes


def tp_runs(mesh2, x, repeats: int) -> dict:
    """9d: the flagship (`serving_model`, phase 4's weights) sharded by
    `shard_params_tp` at `TP_MIN_CHANNELS` on the grid `mesh2`, through
    `make_tp_apply` on this rank's rows of the batch `x` ([N, H, W, 3] on
    the host): `repeats` calls (the first, then warm), then one more with
    each collective timed from an idle device to its end (the host staging
    under gloo and the wait for the peer ranks included: an upper bound of
    their cost), every count set to 0 before each.  Returns each plain
    call's wall ms, the timed call's wall ms and its collectives' own, the
    last call's logits (on the host), launches, plain-version calls, the
    mode's `COUNTS`, K2 calls through `models.blocks` ((input shape + Cout,
    relu) -> [calls, "whole" | "column" | "row"]) and K1 calls through
    `models.encoders` (`k1_calls`: (input shape, Cout, residual,
    channels_last) -> calls) with the folded weights of each (`k1_weights`,
    on the host), this process's peak memory over the calls, and its
    parameter bytes: all of them, the split weights' (by kind) and what the
    split weights would hold whole."""
    import torch

    from enhanced_unet_tpu_torch.models import blocks, encoders
    from enhanced_unet_tpu_torch.ops.kernels import conv_fused, depthwise, mbconv
    from enhanced_unet_tpu_torch.ops.partition import split_of
    from enhanced_unet_tpu_torch.parallel import make_tp_apply, shard_params_tp
    from enhanced_unet_tpu_torch.parallel import tensor_parallel as tp

    dev = mesh2.device
    counters = (conv_fused.LAUNCHES, mbconv.LAUNCHES, depthwise.LAUNCHES, tp.COUNTS)
    model = shard_params_tp(serving_model(device=dev).eval(), mesh2, TP_MIN_CHANNELS)
    splits = [(p, split_of(p)) for p in model.parameters()]
    param_bytes = {"all": sum(p.numel() * p.element_size() for p, _ in splits)}
    for kind in ("column", "row"):
        mine = [(p, s) for p, s in splits if s is not None and s.kind == kind]
        param_bytes[kind] = {"count": len(mine),
                             "bytes": sum(p.numel() * p.element_size() for p, _ in mine),
                             "whole_bytes": sum(p.numel() * p.element_size() * s.full
                                                // (s.hi - s.lo) for p, s in mine)}
    rows = x.shape[0] // mesh2.shape[0]
    x_local = x[mesh2.data.rank * rows:(mesh2.data.rank + 1) * rows]
    fwd = make_tp_apply(model, mesh2)
    k2_entry, k1_entry = blocks.fused_conv3x3_bn_relu_packed, encoders.mbconv_infer_nchw
    k2_calls, k1_calls, k1_weights, seen = {}, {}, {}, {}

    def recording_k2(xh, packed, relu=True):
        # the mode counts each K2 call by kind just before it launches
        kind = next(k for k in ("k2_whole", "k2_column", "k2_row")
                    if tp.COUNTS[k] != seen[k])
        seen.update(tp.COUNTS)
        key = (tuple(xh.shape) + (packed.cout,), relu)
        k2_calls.setdefault(key, [0, kind[3:]])[0] += 1
        return k2_entry(xh, packed, relu)

    def recording_k1(xk, p, *, residual, rows=None, reduce=None, hw=None):
        key = (tuple(xk.shape), p.wproj.shape[1], residual,
               xk.is_contiguous(memory_format=torch.channels_last))
        k1_calls[key] = k1_calls.get(key, 0) + 1
        k1_weights.setdefault(key, p)
        return k1_entry(xk, p, residual=residual, rows=rows, reduce=reduce, hw=hw)

    collective_ms = [0.0]             # the timed call's collectives' own wall ms
    real = {"gather": tp.gather, "all_sum_": tp.all_sum_}

    def timed(fn):
        def run(*args):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize(dev)
            collective_ms[0] += 1e3 * (time.perf_counter() - t0)
            return out
        return run

    plain, restore = count_plain()
    blocks.fused_conv3x3_bn_relu_packed = recording_k2
    encoders.mbconv_infer_nchw = recording_k1
    ms = []
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        for call in range(repeats + 1):
            if call == repeats:
                tp.gather, tp.all_sum_ = timed(real["gather"]), timed(real["all_sum_"])
            reset(counters)
            plain.update(conv3x3_bn_act=0, mbconv=0)
            k2_calls.clear()
            k1_calls.clear()
            seen.update(tp.COUNTS)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            with torch.no_grad():
                y = fwd(x_local)
            torch.cuda.synchronize(dev)
            ms.append(1e3 * (time.perf_counter() - t0))
    finally:
        restore()
        blocks.fused_conv3x3_bn_relu_packed, encoders.mbconv_infer_nchw = k2_entry, k1_entry
        tp.gather, tp.all_sum_ = real["gather"], real["all_sum_"]
    weights = {key: {f: None if t is None else t.cpu() for f, t in p._asdict().items()}
               for key, p in k1_weights.items()}
    return {"ms": ms[:repeats], "timed_ms": ms[repeats], "collective_ms": collective_ms[0],
            "peak": torch.cuda.max_memory_allocated(dev),
            "launches": {k: v for c in counters[:3] for k, v in c.items() if v},
            "plain": dict(plain), "counts": dict(tp.COUNTS), "k2_calls": dict(k2_calls),
            "k1_calls": dict(k1_calls), "k1_weights": weights,
            "logits": y.float().cpu(), "param_bytes": param_bytes}


def tp_two_ranks(mesh, out_dir: str):
    """9d (b), one of two ranks sharing the card over gloo: the grid 1 x 2,
    `tp_runs` on the batch `out_dir/batch.pt`, two calls and the timed one;
    each rank writes what it returns, rank 1 without the logits and K1's
    weights (the ranks of a grid row return the same)."""
    import os

    import torch

    from enhanced_unet_tpu_torch.parallel import make_mesh_2d

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.load(os.path.join(out_dir, "batch.pt"))
    out = tp_runs(make_mesh_2d(1, 2, device=mesh.device), x, 2)
    if mesh.rank:
        del out["logits"], out["k1_weights"]
    torch.save(out, os.path.join(out_dir, f"rank{mesh.rank}.pt"))


def phase9d_tensor_parallel(card: str, dev, tmp: str, k2_row, covered) -> dict:
    """9d. Tensor parallelism's forward on the card (see the module
    docstring); `covered`: the (shape, relu) K2 rows of phase 4b.  Returns
    the readings, K2's rows at the new shapes and K1's at the 1 x 2 call's,
    and the partial sums' error."""
    import os

    import torch

    from enhanced_unet_tpu_torch.parallel import make_mesh_2d, spawn

    t_phase = time.perf_counter()
    x = torch.from_numpy(synthetic_images(TP_BATCH, TP_HW, 19))

    # ---- one process: the model's own forward (the reference), the first
    # call and a warm one, its peak and parameter bytes
    model = serving_model(device=dev).eval()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    with torch.no_grad():
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = model(x.to(dev))[0]
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
    ref = {"ms": ms, "logits": y.float().cpu(), "peak": torch.cuda.max_memory_allocated(),
           "param_bytes": sum(p.numel() * p.element_size() for p in model.parameters())}
    del model, y

    def held(r, what):
        """The checks of one tensor-parallel run against the one-process
        forward."""
        logits, want = r["logits"], ref["logits"]
        masks = logits.argmax(-1)
        err = (logits - want).abs().max().item() / want.abs().max().item()
        agree = (masks == want.argmax(-1)).double().mean().item()
        launches, counts, pb = r["launches"], r["counts"], r["param_bytes"]
        k2 = launches.get("conv3x3_bn_act_wgmma", 0) + launches.get("conv3x3_bn_act_smallc", 0)
        k1 = launches.get("mbconv_nhwc_pass1", 0)
        print(f"[{card}] {what}: wall ms {[round(t, 1) for t in r['ms']]} (one process "
              f"{[round(t, 1) for t in ref['ms']]}); a call with its collectives timed "
              f"{r['timed_ms']:.1f}, of it the collectives' {r['collective_ms']:.1f} (each "
              f"from an idle device: an upper bound, the wait for the peer included); "
              f"peak {r['peak']} bytes (one process "
              f"{ref['peak']}); parameter bytes {pb['all']} (one process "
              f"{ref['param_bytes']}; column splits {pb['column']}, row splits {pb['row']}); "
              f"collectives {counts['all_gather']} all-gathers, {counts['all_reduce']} "
              f"all-reduces; K2 calls whole {counts['k2_whole']}, column {counts['k2_column']}, "
              f"row (no epilogue) {counts['k2_row']}; launches {json.dumps(launches)}; "
              f"plain-version calls {r['plain']}; max |logit diff| / max |logit| {err:.3e} "
              f"(tol {TP_TOL:g}); pixels of the same class {agree:.6f} (tol {TP_AGREE})")
        check(tuple(masks.shape) == tuple(want.shape[:3])
              and set(masks.unique().tolist()) <= {0, 1, 2}, f"{what}: masks in {{0,1,2}}")
        check(bool(torch.isfinite(logits).all()), f"{what}: finite logits")
        check(err <= TP_TOL, f"{what}: logits within {TP_TOL} of the one process's")
        check(agree >= TP_AGREE, f"{what}: classes agree on {TP_AGREE} of pixels")
        check(counts["k2_column"] > 0 and counts["k2_row"] > 0,
              f"{what}: K2 launched on column and on row slices")
        check(counts["k2_whole"] + counts["k2_column"] + counts["k2_row"] == k2
              == sum(c for c, _ in r["k2_calls"].values()),
              f"{what}: every K2 launch one of the recorded calls")
        check(not any(kind == "row" for (_, relu), (_, kind) in r["k2_calls"].items() if relu),
              f"{what}: no row-split K2 call with its ReLU epilogue")
        check(k1 > 0 and launches.get("mbconv_nhwc_pass2", 0) == k1 and not counts["k1_gathered"],
              f"{what}: K1's nhwc passes launched on whole weights")
        check(r["plain"] == {"conv3x3_bn_act": 0, "mbconv": 0},
              f"{what}: no plain version of K1 or K2 ({r['plain']})")
        other = {k: v for k, v in launches.items() if k not in (
            "conv3x3_bn_act_wgmma", "conv3x3_bn_act_smallc", "mbconv_nhwc_pass1",
            "mbconv_nhwc_pass2")}
        check(not other, f"{what}: no other kernel ({other})")
        check(sum(r["k1_calls"].values()) == k1, f"{what}: every K1 launch a recorded call")
        return {"ms": r["ms"], "timed_ms": r["timed_ms"], "collective_ms": r["collective_ms"],
                "peak": r["peak"], "err": err, "agree": agree, "launches": launches,
                "counts": counts, "param_bytes": pb}

    out = {"card": card, "one_process": {k: v for k, v in ref.items() if k != "logits"}}
    # ---- (a) the grid 1 x 1 over NCCL
    os.makedirs(os.path.join(tmp, "tp1"))
    mesh2 = make_mesh_2d(1, 1, init_dir=os.path.join(tmp, "tp1"))
    try:
        r = tp_runs(mesh2, x, 2)
    finally:
        torch.distributed.destroy_process_group()
    out["1x1"] = held(r, f"tensor parallel flagship {TP_BATCH} x {TP_HW}^2, grid 1 x 1 over NCCL")
    pb = r["param_bytes"]
    check(pb["all"] == ref["param_bytes"] and pb["column"]["bytes"] == pb["column"]["whole_bytes"],
          "1 x 1: every weight whole")
    del r

    # ---- (b) the grid 1 x 2: two ranks sharing the card over gloo
    ranks_dir = os.path.join(tmp, "tp2")
    os.makedirs(ranks_dir)
    torch.save(x, os.path.join(ranks_dir, "batch.pt"))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    spawn(tp_two_ranks, 2, (ranks_dir,), device="cuda:0", backend="gloo", init_dir=ranks_dir,
          timeout=600)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(ranks_dir, f"rank{q}.pt")) for q in range(2)]
    res = held(ranks[0], f"tensor parallel flagship {TP_BATCH} x {TP_HW}^2, grid 1 x 2, two ranks "
                         f"on one card over gloo, rank 0 (rank 1: wall ms "
                         f"{[round(t, 1) for t in ranks[1]['ms']]}, peak {ranks[1]['peak']} bytes, "
                         f"counts {ranks[1]['counts']}, launches "
                         f"{json.dumps(ranks[1]['launches'])})")
    for q, rank in enumerate(ranks):
        pb = rank["param_bytes"]
        check(pb["column"]["count"] == 267 and pb["row"]["count"] == 4,
              f"rank {q}: 267 column-split and 4 row-split weights")
        check(all(2 * pb[k]["bytes"] == pb[k]["whole_bytes"] for k in ("column", "row")),
              f"rank {q}: the split weights hold half their bytes")
        check(rank["counts"] == ranks[0]["counts"], f"rank {q}: the same collectives")
    res.update(ms=[rank["ms"] for rank in ranks], peak=[rank["peak"] for rank in ranks],
               timed_ms=[rank["timed_ms"] for rank in ranks],
               collective_ms=[rank["collective_ms"] for rank in ranks], spawn_s=spawn_s)
    out["1x2"] = res
    print(f"[{card}] grid 1 x 2: spawn to join {spawn_s:.1f} s")

    # ---- (c) K2 at each shape (b) gave it that phase 4b did not
    t0 = time.perf_counter()
    k2_rows = []
    for (shape, relu), (count, kind) in sorted(ranks[0]["k2_calls"].items()):
        if (shape, relu) in covered:
            continue
        r = k2_row(shape[:5], relu, iters=TP_K2_ITERS)
        r.update(launches=count, split=kind)
        print_k2(r, f"tensor parallel ({kind}, {count} a call) ")
        k2_rows.append(r)
    check(k2_rows and all(r["variant"] in ("wgmma", "smallc") for r in k2_rows),
          "every new tensor-parallel K2 shape reaches the wgmma or the small-Cin kernel")
    check({r["split"] for r in k2_rows} >= {"column", "row"},
          "K2 held at new column- and row-split shapes")
    per_call = {k: sum(r["launches"] * r[k] for r in k2_rows)
                for k in ("ms", "wall_ms", "bound_ms", "library_ms", "library_conv_ms",
                          "plain_ms")}
    print(f"K2 per tensor-parallel flagship call on the 1 x 2 grid, its {len(k2_rows)} new shapes "
          f"({sum(r['launches'] for r in k2_rows)} launches; sum of launches x time): kernel "
          f"{per_call['ms']:.4f} ms (unheld {per_call['wall_ms']:.4f}), bound "
          f"{per_call['bound_ms']:.4f}, cuDNN + epilogue {per_call['library_ms']:.4f}, cuDNN "
          f"conv alone {per_call['library_conv_ms']:.4f}, plain {per_call['plain_ms']:.4f}; "
          f"{time.perf_counter() - t0:.1f} s")
    out["k2_rows"], out["k2_per_call"] = k2_rows, per_call
    row_shapes = [shape for (shape, _), (_, kind) in ranks[0]["k2_calls"].items()
                  if kind == "row"]
    out["partial_sums"] = tp_partial_sums(dev, max(row_shapes, key=lambda t: t[1] * t[2]),
                                          mesh_size=2)
    out["k1_rows"] = tp_k1_rows(dev, ranks[0]["k1_calls"], ranks[0]["k1_weights"])
    print(f"[{card}] phase 9d (tensor parallelism): {time.perf_counter() - t_phase:.1f} s")
    return out


def tp_partial_sums(dev, shape, mesh_size: int) -> dict:
    """9d (c): what K2's row-split call costs in error.  At `shape` (N, H,
    W, Cin / mesh_size, Cout: one rank's slice), seeded bf16 x and weights
    with a BN folded to scale and shift: the path's result (K2 on each
    rank's slice of the input channels with scale 1, shift 0 and no ReLU,
    the bf16 partial sums added in fp32, then scale, shift and ReLU, cast
    to bf16 once; also with one rank's whole input, as the grid 1 x 1 runs
    it) and K2 with its fused epilogue on the whole input, each against
    conv + BN + ReLU in fp32 on the same bf16 values (TF32 off), as max
    |diff| / max |reference|."""
    import torch
    import torch.nn.functional as F

    from enhanced_unet_tpu_torch.ops.kernels import conv_fused

    n, h, w, cpart, cout = shape
    cin = cpart * mesh_size
    g = torch.Generator(device=dev).manual_seed(23)
    bf16 = torch.bfloat16
    with torch.no_grad():
        x = torch.randn(n, h, w, cin, generator=g, device=dev).to(bf16)
        wt = (torch.randn(3, 3, cin, cout, generator=g, device=dev) / (9 * cin) ** 0.5
              ).to(bf16).float()
        sc = torch.rand(cout, generator=g, device=dev) + 0.5
        sh = torch.randn(cout, generator=g, device=dev) * 0.1
        ref = torch.relu(F.conv2d(x.permute(0, 3, 1, 2).float(), wt.permute(3, 2, 0, 1),
                                  padding=1) * sc.view(1, -1, 1, 1) + sh.view(1, -1, 1, 1))
        ref = ref.permute(0, 2, 3, 1)
        top = ref.abs().max().item()
        ones, zeros = torch.ones_like(sc), torch.zeros_like(sh)

        def after_sum(parts):
            y = sum(q.float() for q in parts)
            return torch.relu(y * sc + sh).to(bf16)

        def partial(lo, hi):
            packed = conv_fused.pack_conv3x3(wt[:, :, lo:hi].contiguous(), ones, zeros, bf16,
                                             dev)
            return conv_fused.fused_conv3x3_bn_relu_packed(
                x[..., lo:hi].contiguous(), packed, False)

        split = after_sum([partial(r * cpart, (r + 1) * cpart) for r in range(mesh_size)])
        one = after_sum([partial(0, cin)])
        fused = conv_fused.fused_conv3x3_bn_relu_packed(
            x, conv_fused.pack_conv3x3(wt, sc, sh, bf16, dev), True)
        torch.cuda.synchronize()

        def err(a, b):
            return (a.float() - b.float()).abs().max().item() / top

        out = {"shape": f"[{n},{h},{w},{cin}]->{cout} bf16, Cin split {mesh_size} ways",
               "split_vs_fp32": err(split, ref), "one_rank_vs_fp32": err(one, ref),
               "fused_vs_fp32": err(fused, ref), "split_vs_fused": err(split, fused)}
    print(f"K2 row split, the partial sums' dtype, {out['shape']}: max |diff| / max |fp32 "
          f"conv + BN + ReLU|: bf16 partials, summed in fp32, then BN + ReLU "
          f"{out['split_vs_fp32']:.3e} ({mesh_size} ranks), {out['one_rank_vs_fp32']:.3e} "
          f"(one rank); K2's fused epilogue {out['fused_vs_fp32']:.3e}; the two paths apart "
          f"{out['split_vs_fused']:.3e}")
    check(all(math.isfinite(v) and v <= 2e-2 for k, v in out.items() if k != "shape"),
          "K2's row-split path and its fused epilogue within 2e-2 of the fp32 chain")
    return out


def tp_k1_rows(dev, k1_calls: dict, k1_weights: dict,
               what: str = "tensor parallel, whole weights") -> list:
    """9d (c): K1 at each shape the 1 x 2 call gave it (`k1_calls`: (input
    shape, Cout, residual, channels_last) -> launches a call), with the
    block's own folded weights from that call (`k1_weights`, on the host),
    on a seeded input of the same shape and layout: the entry against
    `mbconv_infer_nchw_plain`, pass 1's sums (within 1e-3 of max |sum|) and
    pass 2 (from the plain sums' gated weights) against their plain
    versions, within 2e-2 (bf16) or 1e-4 (fp32) of max |value|; each pass
    timed beside its plain version and its bound.  Returns the rows."""
    import torch

    from enhanced_unet_tpu_torch.benchmarks.microtime import device_ms
    from enhanced_unet_tpu_torch.ops.kernels import mbconv

    g = torch.Generator(device=dev).manual_seed(29)
    passes = {"nhwc": (mbconv.mbconv_nhwc_pass1, mbconv.mbconv_nhwc_pass2),
              "nhwc_expand": (mbconv.mbconv_nhwc_expand_pass1,
                              mbconv.mbconv_nhwc_expand_pass2),
              "nchw": (mbconv.mbconv_pass1, mbconv.mbconv_pass2)}
    rows = []
    for key, count in sorted(k1_calls.items()):
        (n, c, h, w), cout, res, cl = key
        p = mbconv.MBConvWeights(**{f: None if t is None else t.to(dev)
                                    for f, t in k1_weights[key].items()})
        dtype = p.wdw.dtype
        with torch.no_grad():
            x = torch.randn(n, h, w, c, generator=g, device=dev).to(dtype).permute(0, 3, 1, 2)
            if not cl:
                x = x.contiguous()
            variant = mbconv.variant_for(x, p)
            pass1, pass2 = passes[variant]
            xk = x.contiguous() if variant == "nchw" else x
            prefix = "mbconv_" if variant == "nchw" else f"mbconv_{variant}_"
            before = dict(mbconv.LAUNCHES)
            got = mbconv.mbconv_infer_nchw(x, p, residual=res)
            torch.cuda.synchronize()
            check(all(mbconv.LAUNCHES[prefix + q] - before[prefix + q] == 1
                      for q in ("pass1", "pass2")),
                  f"K1 {key}: the entry launched the {variant} kernels")
            want = mbconv.mbconv_infer_nchw_plain(x, p, residual=res)
            err = (got.float() - want.float()).abs().max().item()
            rel = err / want.float().abs().max().item()
            sums = pass1(xk, p)
            want1 = mbconv.mbconv_pass1_plain(x, p)
            err1 = (sums - want1).abs().max().item()
            rel1 = err1 / want1.abs().max().item()
            wpp = mbconv.se_gated_projection(want1, p, h * w, dtype)
            y = pass2(xk, p, wpp, res)
            torch.cuda.synchronize()
            y_want = mbconv.mbconv_pass2_plain(x, p, wpp, res)
            err2 = (y.float() - y_want.float()).abs().max().item()
            rel2 = err2 / y_want.float().abs().max().item()
            del got, want, sums, y, y_want
        bf16 = dtype == torch.bfloat16
        tol, kind = (2e-2, "bf16") if bf16 else (1e-4, "fp32")
        mid, expand, es = p.wdw.shape[0], p.wexp is not None, x.element_size()
        hw = n * h * w
        ops = (2 * c + 5) * mid * expand + 23 * mid
        w_bytes = (mid * c * es + mid * 4) * expand + mid * (9 * es + 4)
        b1, by1 = bound(hw * c * es + w_bytes + n * mid * 4, hw * (ops + mid), kind)
        b2, by2 = bound(hw * (c + cout) * es + w_bytes + n * mid * cout * es + cout * 4,
                        hw * (ops + 2 * mid * cout + 2 * cout), kind)
        what = f"[{n},{c},{h},{w}] mid {mid}"
        for q, shape, e, r, kernel, plain, b, by in (
                ("pass1", f"{what} {kind}", err1, rel1, lambda: pass1(xk, p),
                 lambda: mbconv.mbconv_pass1_plain(x, p), b1, by1),
                ("pass2", f"{what} ->{cout}{' residual' if res else ''} {kind}", err2, rel2,
                 lambda: pass2(xk, p, wpp, res),
                 lambda: mbconv.mbconv_pass2_plain(x, p, wpp, res), b2, by2)):
            row = dict(name=prefix + q, variant=variant, shape=shape, split="whole",
                       launches=count, max_abs_err=e, rel_err=r, entry_rel_err=rel,
                       ms=device_ms(kernel, K1_ITERS),
                       wall_ms=device_ms(kernel, K1_ITERS, held=False),
                       plain_ms=device_ms(plain, K1_ITERS),
                       bound_ms=b, bound_by=by, library_ms=None)
            print(f"K1 {row['name']} {shape} ({what}, {count} a call): "
                  f"rel err {r:.3e} (tol {1e-3 if q == 'pass1' else tol:g}; the entry "
                  f"{rel:.3e}, tol {tol:g}); kernel {row['ms']:.4f} ms (unheld "
                  f"{row['wall_ms']:.4f}), plain {row['plain_ms']:.4f}, bound {b:.4f} ({by})")
            rows.append(row)
        check(rel <= tol, f"K1 entry {key} within {tol} of mbconv_infer_nchw_plain")
        check(rel1 <= 1e-3, f"K1 {variant} pass 1 {key} sums within 1e-3 of the plain version")
        check(rel2 <= tol, f"K1 {variant} pass 2 {key} within {tol} of the plain version")
        del x, xk, wpp, p
    check(rows, "K1 held at the tensor-parallel call's shapes")
    return rows


TPT_HW, TPT_BATCH, TPT_STEPS = 512, 2, 3   # phase 9e (a): the global batch, steps a grid
TPT_SEED = 41                              # the dropout and stochastic-depth generator's
TPT_LOSS_TOL = 1e-2                        # the first loss against the one process's
TPT_GRIDS = ((1, 2), (2, 1))               # 9e (a) on two ranks sharing the card
TPT_EXACT_HW = 128                         # 9e (a): the two-rank grids' float64 step
TPT_WIDE = (8, 256)                        # 9e (a): fp32 against float64 at batch 8
TPT_EXACT_TOL = 1e-5                       # float64 gradient trees' relative L2
MESH_TOL, MESH_AGREE = 5e-2, 0.9999        # 9e (b): of the max probability; pixels
MESH_CALLS = 2                             # 9e (b): served requests a run (first, warm)


def recording_norms(state, norms: list, first=None) -> None:
    """Have `state.tx.update` append the global gradient norm it clips by
    (the one it is given, or the one it computes) to `norms`, and to the
    list `first`, if given, the first update's gradients before the clip
    (fp32, on the host)."""
    import torch

    real = state.tx.update

    def update(params, grads, opt_state, norm=None):
        used = norm
        if used is None:
            g = [v for v in grads.values() if v is not None]
            used = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
        norms.append(float(used))
        if first is not None and not first:
            first.append({n: v.float().cpu() for n, v in grads.items() if v is not None})
        return real(params, grads, opt_state, norm=norm)

    state.tx.update = update


def tpt_reference(dev, batch, dtype=None) -> dict:
    """9e (a): one step of the one-process `make_train_step` on the whole
    batch from phase 6a's weights (the flagship at full width, bf16
    compute unless `dtype` says otherwise, the preset's dropout and
    stochastic depth), the generator seeded `TPT_SEED`: loss, the global
    gradient norm, wall ms, peak and the parameter and AdamW-moment
    bytes."""
    import torch

    from enhanced_unet_tpu_torch.config import get_preset
    from enhanced_unet_tpu_torch.models import get_model
    from enhanced_unet_tpu_torch.train.trainer import create_train_state, make_train_step

    cfg = get_preset("enhanced_unet")
    model = get_model("enhanced_unet", seed=0, device=dev,
                      **({} if dtype is None else {"dtype": dtype}))
    state = create_train_state(model, cfg, STEPS_PER_EPOCH, device=dev)
    norms, grads = [], []
    recording_norms(state, norms, grads)
    images, masks, valid = (t.to(dev) for t in batch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    state, out = make_train_step(cfg)(state, images, masks, valid,
                                      torch.Generator(device=dev).manual_seed(TPT_SEED))
    loss = out["loss"].item()
    ms = 1e3 * (time.perf_counter() - t0)
    opt = state.opt_state
    return {"loss": loss, "norm": norms[0], "ms": ms, "grads": grads[0],
            "peak": torch.cuda.max_memory_allocated(dev),
            "param_bytes": sum(p.numel() * p.element_size() for p in model.parameters()),
            "moment_bytes": sum(t.numel() * t.element_size()
                                for t in [*opt.mu.values(), *opt.nu.values()])}


POOL_BN = "deeplab.decoder.aspp.0.convs.4.2"   # the ASPP image-level branch's BatchNorm


def tpt_grads(dev, batch, dtype, mesh2=None, tiny: bool = False,
              pool_bn_eval: bool = False) -> dict:
    """9e (a): one step of the flagship in `dtype` (float64 casts its
    parameters too), the preset's dropout and stochastic depth, a generator
    seeded `TPT_SEED`: at full width from phase 6a's weights, or with `tiny`
    the efficientnet-tiny flagship (seed 4).  `make_train_step` on the whole
    batch without `mesh2`, else `make_tp_train_step` on this rank's rows
    with its weights split by `shard_params_tp` (at `TP_MIN_CHANNELS`, tiny
    at 16).  `pool_bn_eval` keeps `POOL_BN` in eval mode (its running
    statistics) through the step.  Returns the loss and each parameter's
    gradient before the clip on the host in float64 with its `Split`
    (None: whole)."""
    import torch

    from enhanced_unet_tpu_torch.config import get_preset
    from enhanced_unet_tpu_torch.models import get_model
    from enhanced_unet_tpu_torch.ops.partition import split_of
    from enhanced_unet_tpu_torch.parallel import make_tp_train_step, shard_params_tp
    from enhanced_unet_tpu_torch.train.trainer import create_train_state, make_train_step

    cfg = get_preset("enhanced_unet")
    model = get_model("enhanced_unet", dtype=dtype, device=dev, seed=4 if tiny else 0,
                      **({"encoder_names": TINY} if tiny else {}))
    if dtype == torch.float64:
        model = model.to(dtype)
    if pool_bn_eval:
        bn = model.get_submodule(POOL_BN)
        bn.training = False
        bn.train = lambda mode=True: bn          # the step's model.train() passes it by
    images, masks, valid = batch
    if mesh2 is None:
        step = make_train_step(cfg)
    else:
        shard_params_tp(model, mesh2, 16 if tiny else TP_MIN_CHANNELS)
        step = make_tp_train_step(cfg, mesh2)
        rows = images.shape[0] // mesh2.shape[0]
        images, masks, valid = (t[mesh2.data.rank * rows:(mesh2.data.rank + 1) * rows]
                                for t in batch)
    state = create_train_state(model, cfg, STEPS_PER_EPOCH, device=dev)
    _, out = step(state, images.to(dev, dtype), masks.to(dev), valid.to(dev),
                  torch.Generator(device=dev).manual_seed(TPT_SEED))
    grads = {n: (p.grad.double().cpu(), split_of(p)) for n, p in model.named_parameters()
             if p.grad is not None}
    loss = out["loss"].item()
    del model, state, out
    torch.cuda.empty_cache()
    return {"loss": loss, "grads": grads}


def whole_grads(ranks: list) -> dict:
    """The gradient tree from each rank's `tpt_grads`: a split weight's
    slices concatenated along its split dimension (the two ranks of a
    1 x 2 grid), a whole one rank 0's."""
    import torch

    out = {}
    for n, (g, split) in ranks[0]["grads"].items():
        out[n] = g if split is None or split.hi - split.lo == split.full else torch.cat(
            [rank["grads"][n][0] for rank in ranks], split.dim)
    return out


def tree_groups(ours: dict, ref: dict) -> dict:
    """The flagship's gradient tree in parts (the UNet++ branch, the
    DeepLabV3+ encoder, the ASPP image-level branch, the rest of its
    decoder and head, the fusion heads): each part's relative L2 distance
    from `ref`'s and the two parts' norms."""
    def part(n):
        if n.startswith(POOL_BN.rsplit(".", 1)[0] + "."):
            return "aspp_pool"
        if n.startswith("deeplab.encoder."):
            return "deeplab.encoder"
        return n.split(".")[0] if n.startswith(("unetpp.", "deeplab.")) else "fusion"

    sums = {}
    for n, v in ref.items():
        d = sums.setdefault(part(n), [0.0, 0.0, 0.0])
        d[0] += ((ours[n] - v) ** 2).sum().item()
        d[1] += (ours[n] ** 2).sum().item()
        d[2] += (v ** 2).sum().item()
    return {k: {"rel": (d / max(r, 1e-300)) ** 0.5, "norm": o ** 0.5, "ref_norm": r ** 0.5}
            for k, (d, o, r) in sums.items()}


def worst_leaves(ours: dict, ref: dict, k: int = 3) -> str:
    """The `k` parameters whose gradients are furthest from `ref`'s, each
    with its relative L2 distance and its share of the tree's squared
    difference."""
    diff = {n: ((ours[n] - v) ** 2).sum().item() for n, v in ref.items()}
    total = max(sum(diff.values()), 1e-300)
    return ", ".join(
        f"{n} {(d / max((ref[n] ** 2).sum().item(), 1e-300)) ** 0.5:.3e} ({d / total:.2f})"
        for n, d in sorted(diff.items(), key=lambda t: -t[1])[:k])


def tpt_runs(mesh2, batch, keep_grads: bool = False) -> dict:
    """9e (a): `make_tp_train_step` on the grid `mesh2`, phase 6a's weights
    sharded by `shard_params_tp` at `TP_MIN_CHANNELS`, this rank's rows of
    the whole batch, `TPT_STEPS` steps from a generator seeded `TPT_SEED`,
    every count set to 0 before each: each step's loss, global gradient
    norm and wall ms, this rank's peak, parameter and AdamW-moment bytes,
    the last step's collectives by kind (`COUNTS`), K1's and K2's launches
    and their plain versions' calls, the split weights' and their moments'
    widths, and, where the grid has two ranks, how far each whole
    parameter, its moments and every running statistic are from rank 0's
    (max |diff| after the last step); with `keep_grads`, the first step's
    gradients before the clip (fp32, on the host)."""
    import torch

    from enhanced_unet_tpu_torch.config import get_preset
    from enhanced_unet_tpu_torch.models import get_model
    from enhanced_unet_tpu_torch.ops.kernels import conv_fused, depthwise, mbconv
    from enhanced_unet_tpu_torch.ops.partition import split_of
    from enhanced_unet_tpu_torch.parallel import make_tp_train_step, shard_params_tp
    from enhanced_unet_tpu_torch.parallel import tensor_parallel as tp
    from enhanced_unet_tpu_torch.train.trainer import create_train_state

    dev = mesh2.device
    cfg = get_preset("enhanced_unet")
    counters = (conv_fused.LAUNCHES, mbconv.LAUNCHES, depthwise.LAUNCHES, tp.COUNTS)
    model = shard_params_tp(get_model("enhanced_unet", seed=0, device=dev), mesh2,
                            TP_MIN_CHANNELS)
    state = create_train_state(model, cfg, STEPS_PER_EPOCH, device=dev)
    norms, grads = [], []
    recording_norms(state, norms, grads if keep_grads else None)
    rows = TPT_BATCH // mesh2.shape[0]
    lo = mesh2.data.rank * rows
    images, masks, valid = (t[lo:lo + rows].to(dev) for t in batch)
    step = make_tp_train_step(cfg, mesh2)
    gen = torch.Generator(device=dev).manual_seed(TPT_SEED)
    plain, restore = count_plain()
    losses, ms = [], []
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(TPT_STEPS):
            reset(counters)
            plain.update(conv3x3_bn_act=0, mbconv=0)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            state, out = step(state, images, masks, valid, gen)
            losses.append(out["loss"].item())
            torch.cuda.synchronize(dev)
            ms.append(1e3 * (time.perf_counter() - t0))
    finally:
        restore()
    params = dict(model.named_parameters())
    opt = state.opt_state
    splits = {n: split_of(p) for n, p in params.items() if split_of(p) is not None}
    halves = all((s.hi - s.lo) * mesh2.shape[1] == s.full
                 and params[n].shape[s.dim] == s.hi - s.lo
                 and opt.mu[n].shape == params[n].shape == opt.nu[n].shape
                 for n, s in splits.items())
    apart = None
    if mesh2.world.size > 1:
        whole = [t for n, p in params.items() if n not in splits
                 for t in (p.detach(), opt.mu[n], opt.nu[n])]
        whole += [b for n, b in model.named_buffers() if n.endswith(("running_mean",
                                                                      "running_var"))]
        mine = torch.cat([t.reshape(-1).double() for t in whole]).cpu()
        first = mine.clone()
        mesh2.world.broadcast_([first])
        apart = (mine - first).abs().max().item()
    return {"losses": losses, "norms": norms, "ms": ms,
            "peak": torch.cuda.max_memory_allocated(dev),
            "param_bytes": sum(p.numel() * p.element_size() for p in params.values()),
            "moment_bytes": sum(t.numel() * t.element_size()
                                for t in [*opt.mu.values(), *opt.nu.values()]),
            "counts": {k: v for k, v in tp.COUNTS.items() if not k.startswith("k")},
            "launches": sum(v for c in counters[:3] for v in c.values()),
            "plain": dict(plain), "splits": len(splits), "halves": halves, "apart": apart,
            **({"grads": grads[0]} if keep_grads else {})}


def mesh_eval_runs(mesh, image) -> dict:
    """9e (b): the full-width flagship (phase 4's weights) served by
    `Evaluator(tiled=True, tile=TILE, overlap=TILE_OVERLAP, mesh=mesh)` with
    TTA: `predict_probs_tiled` once, then `predict_semantic_mask`
    `MESH_CALLS` times, every count set to 0 before each.  Returns the
    probabilities and the last mask (on the host), each request's wall ms,
    the tile shares this rank forwarded a request, the last request's
    launches and plain-version calls, and the K2 and K1 calls it made
    (`k2_calls`: (input shape + Cout, relu) -> calls; `k1_calls` as in
    `tp_runs`, with each block's folded weights)."""
    import torch

    from enhanced_unet_tpu_torch.models import blocks, encoders
    from enhanced_unet_tpu_torch.ops.kernels import conv_fused, depthwise, mbconv
    from enhanced_unet_tpu_torch.train.evaluator import Evaluator

    dev = mesh.device
    counters = (conv_fused.LAUNCHES, mbconv.LAUNCHES, depthwise.LAUNCHES)
    ev = Evaluator(serving_model(device=dev), "enhanced_unet", tiled=True, tile=TILE,
                   overlap=TILE_OVERLAP, mesh=mesh, verbose=False)
    shares = []
    tile_probs = ev._tile_probs
    ev._tile_probs = lambda t: shares.append(t.shape[0]) or tile_probs(t)
    k2_entry, k1_entry = blocks.fused_conv3x3_bn_relu_packed, encoders.mbconv_infer_nchw
    k2_calls, k1_calls, k1_weights = {}, {}, {}

    def recording_k2(xh, packed, relu=True):
        key = (tuple(xh.shape) + (packed.cout,), relu)
        k2_calls[key] = k2_calls.get(key, 0) + 1
        return k2_entry(xh, packed, relu)

    def recording_k1(xk, p, *, residual, rows=None, reduce=None, hw=None):
        key = (tuple(xk.shape), p.wproj.shape[1], residual,
               xk.is_contiguous(memory_format=torch.channels_last))
        k1_calls[key] = k1_calls.get(key, 0) + 1
        k1_weights.setdefault(key, p)
        return k1_entry(xk, p, residual=residual, rows=rows, reduce=reduce, hw=hw)

    plain, restore = count_plain()
    blocks.fused_conv3x3_bn_relu_packed = recording_k2
    encoders.mbconv_infer_nchw = recording_k1
    ms = []
    try:
        probs = ev.predict_probs_tiled(image)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(MESH_CALLS):
            reset(counters)
            plain.update(conv3x3_bn_act=0, mbconv=0)
            k2_calls.clear()
            k1_calls.clear()
            shares.clear()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            mask = ev.predict_semantic_mask(image)
            torch.cuda.synchronize(dev)
            ms.append(1e3 * (time.perf_counter() - t0))
    finally:
        restore()
        blocks.fused_conv3x3_bn_relu_packed, encoders.mbconv_infer_nchw = k2_entry, k1_entry
    weights = {key: {f: None if t is None else t.cpu() for f, t in p._asdict().items()}
               for key, p in k1_weights.items()}
    return {"probs": probs, "mask": mask, "ms": ms, "shares": list(shares),
            "peak": torch.cuda.max_memory_allocated(dev),
            "launches": {k: v for c in counters for k, v in c.items() if v},
            "plain": dict(plain), "k2_calls": dict(k2_calls), "k1_calls": dict(k1_calls),
            "k1_weights": weights}


def tpt_two_ranks(mesh, out_dir: str):
    """9e, one of two ranks sharing the card over gloo: (a) `tpt_grads` of
    the tiny flagship and of the full-width one at `TPT_EXACT_HW` in
    float64, and `tpt_runs`, on each grid of `TPT_GRIDS` (both made on the
    same process group), (b)
    `mesh_eval_runs` on the two ranks' data axis.  Each rank writes what
    they return, rank 1 without the probabilities and K1's weights."""
    import os

    import numpy as np
    import torch

    from enhanced_unet_tpu_torch.parallel import make_mesh_2d

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = torch.load(os.path.join(out_dir, "batch.pt"))
    tiny = torch.load(os.path.join(out_dir, "tiny.pt"))
    small = torch.load(os.path.join(out_dir, "small.pt"))
    out = {}
    for grid in TPT_GRIDS:
        mesh2 = make_mesh_2d(*grid, device=mesh.device)
        out["tiny", grid] = tpt_grads(mesh.device, tiny, torch.float64, mesh2, tiny=True)
        out["exact", grid] = tpt_grads(mesh.device, small, torch.float64, mesh2)
        out[grid] = tpt_runs(mesh2, batch)
        torch.cuda.empty_cache()
    out["mesh"] = mesh_eval_runs(mesh, np.load(os.path.join(out_dir, "micrograph.npy")))
    if mesh.rank:
        del out["mesh"]["probs"], out["mesh"]["k1_weights"]
    torch.save(out, os.path.join(out_dir, f"rank{mesh.rank}.pt"))


def phase9e_tp_train_and_mesh_evaluator(card: str, dev, tmp: str, k2_row, covered) -> dict:
    """9e. Tensor parallelism's train step and the Evaluator's mesh on the
    card (see the module docstring); `covered`: the (shape, relu) K2 rows of
    phase 4b.  Returns the readings, and K2's and K1's rows at the tile
    chunk's shapes on two ranks."""
    import os

    import numpy as np
    import torch

    from enhanced_unet_tpu_torch.parallel import make_mesh, make_mesh_2d, spawn
    from enhanced_unet_tpu_torch.train.evaluator import Evaluator

    t_phase = time.perf_counter()
    batch = tuple(torch.from_numpy(a) for a in blob_batch(TPT_BATCH, TPT_HW, TPT_HW, 43))
    tiny = tuple(torch.from_numpy(a) for a in blob_batch(TPT_BATCH, 64, 64, 44))
    small = tuple(torch.from_numpy(a)
                  for a in blob_batch(TPT_BATCH, TPT_EXACT_HW, TPT_EXACT_HW, 45))
    wide = tuple(torch.from_numpy(a) for a in blob_batch(TPT_WIDE[0], TPT_WIDE[1], TPT_WIDE[1], 46))
    image = synthetic_images(1, TILED_SIZE, 47)[0]
    f32, f64 = torch.float32, torch.float64

    # ---- (a) the one process's step (and in fp32, the bf16 step's
    # yardstick), its gradients in float64 (at the batch, at the two-rank
    # grids' `TPT_EXACT_HW`, the tiny flagship's) and, at batch 8, in fp32
    # and float64; then the grid 1 x 1 over NCCL, also in fp32 and float64
    ref = tpt_reference(dev, batch)
    ref32 = tpt_reference(dev, batch, f32)
    exact = {"one_process": tpt_grads(dev, batch, f64), "small": tpt_grads(dev, small, f64),
             "tiny": tpt_grads(dev, tiny, f64, tiny=True),
             "wide32": tpt_grads(dev, wide, f32), "wide64": tpt_grads(dev, wide, f64),
             "pool32": tpt_grads(dev, batch, f32, pool_bn_eval=True),
             "pool64": tpt_grads(dev, batch, f64, pool_bn_eval=True)}
    os.makedirs(os.path.join(tmp, "tpt1"))
    mesh2 = make_mesh_2d(1, 1, init_dir=os.path.join(tmp, "tpt1"))
    try:
        runs = {(1, 1): tpt_runs(mesh2, batch, keep_grads=True)}
        torch.cuda.empty_cache()
        exact["1x1"] = tpt_grads(dev, batch, f64, mesh2)
        exact["1x1_fp32"] = tpt_grads(dev, batch, f32, mesh2)
    finally:
        torch.distributed.destroy_process_group()
    torch.cuda.empty_cache()

    # ---- (b) the one process's tiled serving (no mesh), then world size 1
    model = serving_model(device=dev)
    one = Evaluator(model, "enhanced_unet", tiled=True, tile=TILE, overlap=TILE_OVERLAP,
                    verbose=False)
    want_probs = one.predict_probs_tiled(image)
    want_mask = one.predict_semantic_mask(image)
    del one, model
    torch.cuda.empty_cache()
    os.makedirs(os.path.join(tmp, "mesh1"))
    mesh = make_mesh(1, init_dir=os.path.join(tmp, "mesh1"))
    try:
        served = {1: mesh_eval_runs(mesh, image)}
    finally:
        torch.distributed.destroy_process_group()
    torch.cuda.empty_cache()

    # ---- (a) 1 x 2 and 2 x 1, (b) two ranks: one spawn sharing the card
    ranks_dir = os.path.join(tmp, "tpt2")
    os.makedirs(ranks_dir)
    torch.save(batch, os.path.join(ranks_dir, "batch.pt"))
    torch.save(tiny, os.path.join(ranks_dir, "tiny.pt"))
    torch.save(small, os.path.join(ranks_dir, "small.pt"))
    np.save(os.path.join(ranks_dir, "micrograph.npy"), image)
    t0 = time.perf_counter()
    spawn(tpt_two_ranks, 2, (ranks_dir,), device="cuda:0", backend="gloo", init_dir=ranks_dir,
          timeout=900)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(ranks_dir, f"rank{q}.pt"), weights_only=False)
             for q in range(2)]
    for grid in TPT_GRIDS:
        runs[grid] = [rank[grid] for rank in ranks]
    served[2] = ranks[0]["mesh"]

    # the backward at full width.  float64 holds it: the 1 x 1 grid at the
    # batch, the two-rank grids at `TPT_EXACT_HW` (and the tiny flagship's).
    # In fp32 and bf16 the gradient trees of one step are far apart however
    # they are reduced: the fp32 one process's from its float64 one, by
    # part, at batch 2, at batch 8 and at batch 2 with the ASPP image-level
    # branch's BatchNorm on its running statistics, says where that comes from
    def tree(r):
        return {n: g for n, (g, _) in r["grads"].items()}

    g64, g32 = tree(exact["one_process"]), ref32.pop("grads")
    ref_grads = ref.pop("grads")
    noise = {"bf16_from_fp32": tree_rel_l2(ref_grads, g32),
             "1x1_from_one_process": tree_rel_l2(runs[1, 1].pop("grads"), ref_grads),
             "fp32_from_fp64": tree_rel_l2(g32, g64),
             "1x1_fp32_from_fp32": tree_rel_l2(tree(exact["1x1_fp32"]), g32),
             "1x1_fp32_from_fp64": tree_rel_l2(tree(exact["1x1_fp32"]), g64),
             "wide_fp32_from_fp64": tree_rel_l2(tree(exact["wide32"]), tree(exact["wide64"])),
             "pool_bn_eval_fp32_from_fp64": tree_rel_l2(tree(exact["pool32"]),
                                                        tree(exact["pool64"]))}
    worst = {"batch 2": worst_leaves(g32, g64),
             f"batch {TPT_WIDE[0]}": worst_leaves(tree(exact["wide32"]), tree(exact["wide64"])),
             "pool BN eval": worst_leaves(tree(exact["pool32"]), tree(exact["pool64"]))}
    parts = {"batch 2": tree_groups(g32, g64),
             f"batch {TPT_WIDE[0]}": tree_groups(tree(exact["wide32"]), tree(exact["wide64"])),
             "pool BN eval": tree_groups(tree(exact["pool32"]), tree(exact["pool64"])),
             "1 x 1 grid, batch 2": tree_groups(tree(exact["1x1_fp32"]), g64)}
    del ref_grads, g32
    out = {"card": card, "one_process": ref, "one_process_fp32": ref32, "spawn_s": spawn_s,
           "gradient_trees": noise, "worst_leaves": worst, "parts": parts}
    print(f"[{card}] 9e (a) one process, flagship b5/b4 bf16 {TPT_BATCH} x {TPT_HW}^2, "
          f"dropout and stochastic depth on: first step {ref['ms']:.1f} ms, loss "
          f"{ref['loss']:.6f}, gradient norm {ref['norm']:.6f}, peak {ref['peak']} bytes, "
          f"parameters {ref['param_bytes']} bytes, AdamW moments {ref['moment_bytes']} bytes; "
          f"the same step in fp32 (the bf16 step's yardstick): loss {ref32['loss']:.6f} (rel "
          f"{abs(ref32['loss'] - ref['loss']) / abs(ref32['loss']):.3e}), gradient norm "
          f"{ref32['norm']:.6f} (rel {abs(ref32['norm'] - ref['norm']) / ref32['norm']:.3e})")
    print(f"[{card}] 9e (a) gradient trees' rel L2 before the clip, {TPT_BATCH} x {TPT_HW}^2: "
          f"the one process's bf16 from its fp32 {noise['bf16_from_fp32']:.3e}, the 1 x 1 grid's "
          f"bf16 from the one process's {noise['1x1_from_one_process']:.3e}; the one process's "
          f"fp32 from its float64 {noise['fp32_from_fp64']:.3e}, the 1 x 1 grid's fp32 from the "
          f"one process's fp32 {noise['1x1_fp32_from_fp32']:.3e} and from its float64 "
          f"{noise['1x1_fp32_from_fp64']:.3e}; at {TPT_WIDE[0]} x {TPT_WIDE[1]}^2 the one "
          f"process's fp32 from its float64 {noise['wide_fp32_from_fp64']:.3e}; at the batch "
          f"with {POOL_BN} on its running statistics {noise['pool_bn_eval_fp32_from_fp64']:.3e}; "
          f"the furthest leaves (rel L2, share of the squared difference): {json.dumps(worst)}")
    for case, by_part in parts.items():
        print(f"[{card}] 9e (a) the fp32 gradient tree from the one process's float64 one by "
              f"part, {case}: " + "; ".join(
                  f"{k} rel {v['rel']:.3e} (norms fp32 {v['norm']:.4e}, float64 "
                  f"{v['ref_norm']:.4e})" for k, v in by_part.items()))
    # float64: the full-width grids (1 x 1 at the batch, the two-rank ones
    # at `TPT_EXACT_HW`) and the tiny flagship's two-rank grids against one
    # process, each split weight's gradient put together from both ranks
    cases = [("full width", (1, 1), f"{TPT_BATCH} x {TPT_HW}^2", [exact["1x1"]],
              exact["one_process"])]
    cases += [("full width", grid, f"{TPT_BATCH} x {TPT_EXACT_HW}^2",
               [rank["exact", grid] for rank in ranks], exact["small"]) for grid in TPT_GRIDS]
    cases += [("tiny flagship", grid, f"{TPT_BATCH} x 64^2", [rank["tiny", grid] for rank in ranks],
               exact["tiny"]) for grid in TPT_GRIDS]
    for kind, grid, size, got, want in cases:
        grads, want_grads = whole_grads(got), tree(want)
        loss_rel = abs(got[0]["loss"] - want["loss"]) / abs(want["loss"])
        rel = tree_rel_l2(grads, want_grads)
        print(f"[{card}] TP train step, {kind} float64 {size}, grid {grid[0]} x {grid[1]} "
              f"({'over NCCL' if grid == (1, 1) else 'two ranks on one card over gloo'}) "
              f"against one process: loss rel {loss_rel:.3e} (tol 1e-6), gradient tree rel L2 "
              f"{rel:.3e} (tol {TPT_EXACT_TOL:g})")
        check(set(grads) == set(want_grads) and loss_rel <= 1e-6 and rel <= TPT_EXACT_TOL,
              f"{kind} float64 grid {grid}: loss and gradients equal one process's")
        out[f"{'tiny' if kind.startswith('tiny') else 'exact'}{grid[0]}x{grid[1]}"] = {
            "loss_rel": loss_rel, "grad_rel": rel}
    del exact, g64
    for grid, r in runs.items():
        rs = r if isinstance(r, list) else [r]
        what = (f"TP train step, grid {grid[0]} x {grid[1]}"
                + (" over NCCL" if grid == (1, 1) else ", two ranks on one card over gloo"))
        loss_rel = abs(rs[0]["losses"][0] - ref["loss"]) / abs(ref["loss"])
        norm_rel = abs(rs[0]["norms"][0] - ref["norm"]) / ref["norm"]
        for q, rq in enumerate(rs):
            print(f"[{card}] {what}, rank {q}: wall ms {[round(t, 1) for t in rq['ms']]} (first, "
                  f"warm); losses {[round(v, 6) for v in rq['losses']]}; gradient norms "
                  f"{[round(v, 6) for v in rq['norms']]}; peak {rq['peak']} bytes; parameters "
                  f"{rq['param_bytes']} bytes, AdamW moments {rq['moment_bytes']} bytes (one "
                  f"process {ref['param_bytes']}, {ref['moment_bytes']}); {rq['splits']} split "
                  f"weights; collectives a step {json.dumps(rq['counts'])}; K1/K2 launches "
                  f"{rq['launches']}, plain-version calls {rq['plain']}; whole tensors from "
                  f"rank 0's {rq['apart']}")
            check(all(math.isfinite(v) for v in rq["losses"]), f"{what}: finite losses")
            check(rq["losses"] == rs[0]["losses"], f"{what}: every rank reports the same loss")
            check(rq["launches"] == 0 and rq["plain"] == {"conv3x3_bn_act": 0, "mbconv": 0},
                  f"{what}: no K1 or K2 launch and no plain version (train mode is stock)")
            check(rq["halves"], f"{what}: every split weight and its moments at width / "
                                f"{grid[1]}")
            check(rq["apart"] in (None, 0.0), f"{what}: whole parameters, moments and running "
                                              "statistics equal across the ranks")
        print(f"[{card}] {what}: first loss rel diff from the one process's {loss_rel:.3e} "
              f"(tol {TPT_LOSS_TOL:g}), gradient norm's {norm_rel:.3e}")
        check(loss_rel <= TPT_LOSS_TOL, f"{what}: first loss within {TPT_LOSS_TOL} of the one "
                                        "process's")
        if grid[1] > 1:
            check(rs[0]["splits"] == 271 and 2 * rs[0]["param_bytes"] < 3 * ref["param_bytes"],
                  f"{what}: 271 split weights, the parameters under 3/4 of the one process's")
        out["x".join(map(str, grid))] = [{k: v for k, v in rq.items()} for rq in rs]

    top = float(want_probs.max())
    for size, r in served.items():
        what = (f"mesh Evaluator, {TILED_SIZE}^2 tile {TILE} overlap {TILE_OVERLAP} TTA, "
                + ("world size 1 over NCCL" if size == 1
                   else "two ranks on one card over gloo, rank 0"))
        err = float(np.abs(r["probs"] - want_probs).max()) / top
        agree = float(np.mean(r["mask"] == want_mask))
        k2 = r["launches"].get("conv3x3_bn_act_wgmma", 0) + r["launches"].get(
            "conv3x3_bn_act_smallc", 0)
        k1 = r["launches"].get("mbconv_nhwc_pass1", 0)
        print(f"[{card}] {what}: wall ms {[round(t, 1) for t in r['ms']]} (first, warm); tile "
              f"shares {r['shares']} ({sum(r['shares'])} tiles forwarded a request, padding "
              f"included); peak {r['peak']} bytes; launches {json.dumps(r['launches'])}; "
              f"plain-version calls {r['plain']}; probabilities max |diff| / max "
              f"{err:.3e} (tol {MESH_TOL:g}); pixels of the same class {agree:.6f} (tol "
              f"{MESH_AGREE})")
        check(r["mask"].shape == want_mask.shape and r["mask"].dtype == np.uint8
              and set(np.unique(r["mask"]).tolist()) <= {0, 1, 2}, f"{what}: a uint8 mask")
        check(err <= MESH_TOL, f"{what}: probabilities within {MESH_TOL} of one process's")
        check(agree >= MESH_AGREE, f"{what}: classes agree on {MESH_AGREE} of pixels")
        check(k2 > 0 and k1 > 0 and r["launches"].get("mbconv_nhwc_pass2", 0) == k1,
              f"{what}: K1 and K2 launched")
        check(r["plain"] == {"conv3x3_bn_act": 0, "mbconv": 0},
              f"{what}: no plain version of K1 or K2")
        check(k2 == sum(r["k2_calls"].values()) and k1 == sum(r["k1_calls"].values()),
              f"{what}: every launch one of the recorded calls")
        out[f"mesh{size}"] = {k: r[k] for k in ("ms", "shares", "peak", "launches", "plain")}
        out[f"mesh{size}"].update(err=err, agree=agree)
    check(len(ranks[1]["mesh"]["shares"]) == len(served[2]["shares"])
          and ranks[1]["mesh"]["launches"] == served[2]["launches"],
          "the two ranks forwarded the same shares")
    print(f"[{card}] 9e two ranks: spawn to join {spawn_s:.1f} s")

    # ---- K2 and K1 at each shape the chunks on two ranks gave them (K2's
    # that phase 4b did not hold)
    t0 = time.perf_counter()
    calls = served[2]["k2_calls"]
    k2_rows = []
    for (shape, relu), count in sorted(calls.items()):
        if (shape, relu) in covered:
            continue
        r = k2_row(shape[:5], relu, iters=TP_K2_ITERS)
        r.update(launches=count, split="whole")
        print_k2(r, f"mesh Evaluator tile chunk ({count} a request a rank) ")
        k2_rows.append(r)
    check(k2_rows and sum(r["launches"] for r in k2_rows)
          + sum(c for key, c in calls.items() if key in covered) == sum(calls.values()),
          "K2 held at every shape of the mesh-served request")
    per_request = {k: sum(r["launches"] * r[k] for r in k2_rows)
                   for k in ("ms", "wall_ms", "bound_ms", "library_ms", "library_conv_ms",
                             "plain_ms")}
    print(f"K2 per mesh-served request a rank (two ranks), its {len(k2_rows)} shapes "
          f"({sum(r['launches'] for r in k2_rows)} launches; sum of launches x time): kernel "
          f"{per_request['ms']:.4f} ms (unheld {per_request['wall_ms']:.4f}), bound "
          f"{per_request['bound_ms']:.4f}, cuDNN + epilogue {per_request['library_ms']:.4f}, "
          f"cuDNN conv alone {per_request['library_conv_ms']:.4f}, plain "
          f"{per_request['plain_ms']:.4f}")
    out["k2_rows"], out["k2_per_request"] = k2_rows, per_request
    out["k1_rows"] = tp_k1_rows(dev, served[2]["k1_calls"], served[2]["k1_weights"],
                                what="mesh Evaluator tile chunk")
    out["mesh_launches"] = served[2]["launches"]
    print(f"[{card}] phase 9e (TP train step, mesh Evaluator): "
          f"{time.perf_counter() - t_phase:.1f} s (K1/K2 rows {time.perf_counter() - t0:.1f} s)")
    return out


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
    from enhanced_unet_tpu_torch.ops.kernels import KERNEL_SOURCES, build
    from enhanced_unet_tpu_torch.ops.kernels import conv_fused, depthwise, mbconv, scse
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
        the plain version, cuDNN + a torch epilogue (`library_ms`), cuDNN's
        channels_last bf16 conv alone (`library_conv_ms`) and the `mma.sync`
        kernel on the same packed weights (`mma_ms`); a wgmma row also gives
        its tile and the bytes its tiles read from L2.  The plain version is
        timed unheld, back to back: its fp32 cuDNN conv holds the host for
        about 0.35 s a call at some shapes (Cin 256 -> 128 at 128^2 on
        cuDNN 9.2), longer than any hold, and elsewhere its calls are long
        enough that held and unheld agree."""
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
            plain_ms=device_ms(lambda: conv_fused.fused_conv3x3_bn_relu_plain(*args), iters,
                               held=False),
            bound_ms=b, bound_by=kind,
            library_ms=device_ms(lambda: conv_library(*args), iters),
            library_conv_ms=device_ms(lambda: F.conv2d(xl, wl, padding=1), iters),
            mma_ms=device_ms(lambda: conv_fused.launch("mma", x, packed, relu), iters)
            if packed.variant != "mma" else None)

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
        dilated = dilated_rows(dev)
        mixffn = mixffn_rows(dev)
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
    # (the windowed pass 1, spatial partitioning's, is phase 9c's)
    for name, count in {**bench_launches, **mbconv.LAUNCHES}.items():
        check(count > 0 or name.endswith("_window"),
              f"kernel {name} was not launched by the benches")
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
    # ---- 3c. the depthwise kernel's two epilogues over a tiled request -----
    results.update(depthwise_entries(dilated, mixffn))
    # ---- 3d. the UNet++ decoder's scSE over a tiled request ---------------
    t0 = time.perf_counter()
    with torch.no_grad():
        results[SCSE] = scse_entry(scse_rows(dev))
    print(f"scSE rows: {time.perf_counter() - t0:.1f} s")
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
    reset([scse.LAUNCHES])
    served = serve_counted(evaluator, requests, counters, "the flagship")
    check(scse.LAUNCHES[SCSE] == SCSE_A_REQUEST * len(requests),
          f"{SCSE_A_REQUEST} scSE calls a request: {scse.LAUNCHES[SCSE]} in {len(requests)}")
    k2_calls, k1_calls, folds = served["k2_calls"], served["k1_calls"], served["folds"]
    times = served["wall_ms"]
    classes_seen = set()
    for ms, masks in zip(times, served["masks"]):
        counts = [int((masks == c).sum()) for c in range(3)]
        classes_seen |= {c for c in range(3) if counts[c]}
        print(f"request: 2x512^2 TTA, {ms:.1f} ms, classes {counts}")
    launches = {**conv_fused.LAUNCHES, **mbconv.LAUNCHES, **depthwise.LAUNCHES}
    print(f"slice: request ms {[round(t, 1) for t in times]}, CUDA-event span ms "
          f"{[round(t, 1) for t in served['span_ms']]}, peak memory {served['peak']} bytes, "
          f"launches {json.dumps(launches)}, K2 weight packs per request {served['packs']}, "
          f"K1 weight folds per request {folds}, forwards {served['forwards'][-1]}")
    check(len(classes_seen) >= 2, f"the cascade decided only {classes_seen}")
    serving = ("conv3x3_bn_act_wgmma", "conv3x3_bn_act_smallc", "mbconv_nhwc_pass1",
               "mbconv_nhwc_pass2", DILATED)
    for name in serving:
        check(launches[name] > 0, f"kernel {name} was not launched by the serving path")
    check(all(run[DILATED] == DILATED_A_REQUEST for run in served["runs"]),
          f"{DILATED_A_REQUEST} dilated depthwise launches a request: "
          f"{[run[DILATED] for run in served['runs']]}")
    off_path = {k: v for k, v in {**launches, **copy_k.LAUNCHES}.items() if k not in serving}
    check(not any(off_path.values()), f"the serving path launched {off_path}")
    check(launches["mbconv_pass1"] == launches["mbconv_pass2"] == 0,
          f"the bf16 request launched no nchw kernel: {launches}")
    k1_per_request = sum(c for c, _ in k1_calls.values())
    check(served["packs"][0] > 0 and folds[0] > 0, "K2 packs and K1 folds on the first request")
    check(served["k1_inputs"] == {(True, True)},
          "every K1 input channels_last and every folded weight in place on the card")
    groups = profile_run(lambda: evaluator.predict_semantic_masks(requests[-1]),
                         min(times[1:]), "one request", extra_groups=SCSE_GROUP)

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
    reset([scse.LAUNCHES])
    tiled_run = serve_counted(tiled, [micrograph] * 3, counters, "tiled serving",
                              serve=tiled.predict_semantic_mask)
    check(scse.LAUNCHES[SCSE] == 3 * SCSE_A_REQUEST,
          f"{SCSE_A_REQUEST} scSE calls a tiled request: {scse.LAUNCHES[SCSE]} in 3")
    tiled_scse = scse.LAUNCHES[SCSE] // 3
    for i, (wall, span, shapes, mask) in enumerate(zip(
            tiled_run["wall_ms"], tiled_run["span_ms"], tiled_run["forwards"],
            tiled_run["masks"])):
        counts = [int((mask == c).sum()) for c in range(3)]
        print(f"tiled request {i + 1}: {TILED_SIZE}^2, tile {TILE}, overlap {TILE_OVERLAP}, "
              f"TTA: wall {wall:.1f} ms, CUDA-event span {span:.1f} ms, forwards {shapes}, "
              f"classes {counts}")
        check(mask.dtype == np.uint8, f"tiled mask {mask.dtype}")
        check(sum(1 for c in counts if c) >= 2, f"the tiled cascade decided only {counts}")
    tiled_mask, tiled_walls = tiled_run["masks"][-1], tiled_run["wall_ms"]
    tiled_launches = tiled_run["runs"][-1]
    print(f"tiled serving: {n_tiles} tiles a request, forwards {tiled_run['forwards'][-1]}, "
          f"peak memory {tiled_run['peak']} bytes, launches per request "
          f"{json.dumps(tiled_launches)}, K2 packs per request {tiled_run['packs']}, K1 folds "
          f"per request {tiled_run['folds']}; K2 shapes {sorted(tiled_run['k2_calls'].items())}; "
          f"K1 shapes {sorted((k, c) for k, (c, _) in tiled_run['k1_calls'].items())}")
    check(all(run == tiled_launches for run in tiled_run["runs"]),
          "every tiled request launches the same kernels")
    check(tiled_run["forwards"][-1] == [(3 * n_tiles, TILE, TILE, 3),
                                        (n_tiles, TILE * 3 // 4, TILE * 3 // 4, 3),
                                        (n_tiles, TILE * 5 // 4, TILE * 5 // 4, 3)],
          f"the whole grid in one chunk: the trio and two scales ({tiled_run['forwards'][-1]})")
    for name in serving:
        check(tiled_launches[name] > 0, f"the tiled path launched {name}")
    check(tiled_launches[DILATED] == DILATED_A_REQUEST,
          f"the tiled path launched {DILATED} {tiled_launches[DILATED]} times a request")
    tiled_off = {k: v for k, v in tiled_launches.items() if k not in serving}
    check(not any(tiled_off.values()), f"the tiled path launched {tiled_off}")
    tiled_groups = profile_run(lambda: tiled.predict_semantic_mask(micrograph),
                               min(tiled_walls[1:]), f"one tiled {TILED_SIZE}^2 request",
                               extra_groups=SCSE_GROUP)
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

    # ---- 4h. SegFormer-B5 served tiled: the Mix-FFN kernel's launches ----
    segformer_run = phase4h_segformer(card, counters, dev)

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

    # ---- 7. the training entry point; 9. the zoo, 9b. the CLI and the
    # data axis, 9c. spatial partitioning, 9d. tensor parallelism and 9e.
    # its train step and the mesh Evaluator, in its folder
    zoo_launches, _, spatial, tensor, mesh = phase7_training_entry(
        card, counters, dev,
        after=lambda tmp, data_dir: (
            phase9_zoo(card, counters, dev, tmp, data_dir, k2_row, set(k2_calls)),
            phase9b_cli_and_data_axis(card, counters, dev, tmp, data_dir),
            phase9c_spatial(card, dev, tmp, k2_row),
            phase9d_tensor_parallel(card, dev, tmp, k2_row, set(k2_calls)),
            phase9e_tp_train_and_mesh_evaluator(card, dev, tmp, k2_row, set(k2_calls))))
    results.update(spatial["entries"])

    # ---- 10. report ------------------------------------------------------
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
        "mbconv_nhwc_pass1_window": ("enhanced_unet_tpu_torch/csrc/mbconv_nhwc.cu",
                                     "enhanced_unet_tpu/ops/pallas/mbconv.py:208"),
        "mbconv_pass1_window": ("enhanced_unet_tpu_torch/csrc/mbconv.cu",
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
        # no Pallas kernel: the JAX package leaves this conv to XLA
        DILATED: ("enhanced_unet_tpu_torch/csrc/depthwise.cu",
                  "none (XLA: enhanced_unet_tpu/models/encoders.py:181)"),
        # no Pallas kernel: the JAX package has no SegFormer
        MIXFFN: ("enhanced_unet_tpu_torch/csrc/depthwise.cu", "none (no SegFormer in JAX)"),
        # no Pallas kernel: the JAX package's parts-list scSE is compiled by XLA
        SCSE: ("enhanced_unet_tpu_torch/csrc/scse.cu",
               "none (XLA: enhanced_unet_tpu/models/packed_blocks.py PackedSCSEMulti)"),
    }
    # launches, each from the run whose time and shape the entry reports:
    # the serving run's for its kernels, the benches' (3b) for theirs (B1:
    # stage 0; B2's passes on the `nchw` kernels), the general path's (phase
    # 3) for K2's mma variant, phase 3's own cases for K1's
    # `nhwc_expand` kernels (the bf16 expand block) and `nchw` ones (the
    # fp32 block), phase 9c's spatial flagship at world size 1 for K1's
    # windowed `nhwc` pass 1 and 9c's own check for the fp32 windowed one,
    # and a tiled request's (4e) for the dilated kernel and the scSE one and
    # SegFormer-B5's (4h) for the Mix-FFN one, whose entries sum those
    # requests' shapes
    path_launches = {**launches, **bench_launches, "conv3x3_bn_act_mma": general_launches,
                     **spatial["launches"],
                     **{k: case_launches["nhwc_expand"][k]
                        for k in ("mbconv_nhwc_expand_pass1", "mbconv_nhwc_expand_pass2")},
                     **{k: case_launches["nchw"][k] for k in ("mbconv_pass1", "mbconv_pass2")},
                     DILATED: tiled_launches[DILATED], SCSE: tiled_scse,
                     MIXFFN: segformer_run["launches"][MIXFFN]}
    # what the spatial flagship's call at world size 1 (9c) launched of the
    # serving kernels
    spatial_kernels = ("conv3x3_bn_act_wgmma", "conv3x3_bn_act_smallc", "mbconv_nhwc_pass2")
    # what the tensor-parallel flagship's call on the 1 x 2 grid (9d, rank 0)
    # launched of the serving kernels, and K2's and K1's rows at its shapes
    tp_kernels = ("conv3x3_bn_act_wgmma", "conv3x3_bn_act_smallc", "mbconv_nhwc_pass1",
                  "mbconv_nhwc_pass2")
    tp_rows = {name: [row for row in tensor["k2_rows"]
                      if f"conv3x3_bn_act_{row['variant']}" == name]
               + [row for row in tensor["k1_rows"] if row["name"] == name]
               for name in tp_kernels}
    # what the mesh Evaluator's request on two ranks (9e (b), rank 0)
    # launched of the same kernels, and their rows at its tile chunk's shapes
    mesh_rows = {name: [row for row in mesh["k2_rows"]
                        if f"conv3x3_bn_act_{row['variant']}" == name]
                 + [row for row in mesh["k1_rows"] if row["name"] == name]
                 for name in tp_kernels}
    kernels = []
    for name, (source, replaces) in meta.items():
        r = results[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": path_launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "wall_ms": r["wall_ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"],
                        **({"design_bound_ms": r["design_bound_ms"]} if "design_bound_ms" in r
                           else {}),
                        **({"tiled_launches": tiled_launches[name]} if name in serving
                           else {}),
                        **({"zoo_launches": {m: k[name] for m, k in zoo_launches.items()}}
                           if name in conv_fused.LAUNCHES else {}),
                        **({"spatial_launches": spatial["spatial_launches"].get(name, 0)}
                           if name in spatial_kernels else {}),
                        **({"tp_launches": tensor["1x2"]["launches"].get(name, 0),
                            "tp_shapes": [{k: row[k] for k in (
                                "shape", "split", "launches", "max_abs_err", "ms", "plain_ms",
                                "bound_ms", "bound_by", "library_ms")}
                                for row in tp_rows[name]]}
                           if name in tp_kernels else {}),
                        **({"mesh_launches": mesh["mesh_launches"].get(name, 0),
                            "mesh_shapes": [{k: row[k] for k in (
                                "shape", "launches", "max_abs_err", "ms", "plain_ms",
                                "bound_ms", "bound_by", "library_ms")}
                                for row in mesh_rows[name]]}
                           if name in tp_kernels else {}),
                        **{k: r[k] for k in ("library_conv_ms", "library_block_ms", "nchw_ms",
                                             "yardstick_ms", "copy_ratio", "bf16_weights_ms",
                                             "request_shapes")
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
