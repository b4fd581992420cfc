"""Drive the PyTorch port's serving path on one CUDA card, end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
 1. the card (`nvidia-smi` name and power limit), torch and CUDA versions;
 2. build every CUDA kernel from `enhanced_unet_tpu_torch/csrc/` (one nvcc
    per source, in parallel), timed;
 3. hold each kernel against its plain PyTorch version at the shapes the
    serving path gives it (bf16; the conv kernel also fp32 with TF32 off),
    and time kernel, plain version, and the library call where one exists;
 4. the slice: `get_model("enhanced_unet")` at full width (EfficientNet-B5
    UNet++ + EfficientNet-B4 DeepLabV3+, bf16, seeded random weights) served
    by an `Evaluator` with TTA: three requests of two 512x512 images; every
    kernel's launch count must move;
 5. cross-check: one 256x256 image, one view, bf16 on the card against the
    same weights in fp32 on the CPU (plain PyTorch path);
 6. a `{"kernels": [...]}` line, the card line, and the final JSON line.

It needs no network and builds into `build/kernels/`.
"""

from __future__ import annotations

import json
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


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of `fn()` over `reps` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS = {"bf16": 989e12, "fp32": 67e12}   # dense tensor-core bf16; fp32 CUDA cores


def bound(bytes_moved: float, ops: float, kind: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def profile_request(evaluator, imgs, wall_ms: float) -> None:
    """Device time of one request by kernel group and by kernel
    (torch.profiler), and the device's idle share of `wall_ms`, the
    request's wall time measured without the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        evaluator.predict_semantic_masks(imgs)
        torch.cuda.synchronize()
    groups, kernels = {}, {}
    total = 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0) or getattr(
            ev, "self_cuda_time_total", 0)
        if us <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = ev.key
        group = ("conv3x3_bn_act (K2)" if "conv3x3_bn_act" in name else
                 "mbconv (K1)" if "mbconv_pass" in name else
                 "cuDNN/cuBLAS conv and matmul" if any(
                     t in name.lower() for t in ("conv", "gemm", "sm90", "xmma", "cudnn", "cutlass"))
                 else "other PyTorch kernels")
        groups[group] = groups.get(group, 0.0) + us / 1e3
        kernels[name] = (kernels.get(name, (0.0, 0))[0] + us / 1e3,
                         kernels.get(name, (0.0, 0))[1] + ev.count)
        total += us / 1e3
    if total <= 0:
        print("profile: no device time recorded (not measured)")
        return
    parts = ", ".join(f"{k} {v:.1f} ms ({100 * v / total:.0f}%)"
                      for k, v in sorted(groups.items(), key=lambda kv: -kv[1]))
    print(f"profile of one request: device time {total:.1f} ms of {wall_ms:.1f} ms "
          f"wall (device idle share {1 - total / wall_ms:.2f}): {parts}")
    for name, (ms, count) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  {ms:8.3f} ms {count:5d} launches  {name[:110]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from enhanced_unet_tpu_torch.ops.kernels import KERNEL_SOURCES, build
    from enhanced_unet_tpu_torch.ops.kernels import conv_fused, mbconv
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

    k2_shapes = [  # (n, h, w, cin, cout): TTA trio of a 2-image 512^2 request
        (6, 512, 512, 6, 256), (6, 512, 512, 256, 128), (6, 512, 512, 128, 64),
        (6, 256, 256, 256, 32),      # UNet++ x_0_3 conv1 (B5: 64 + 4*48 -> 32)
    ]
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        for shape in k2_shapes:
            args = conv_case(*shape, dtype)
            got = conv_fused.fused_conv3x3_bn_relu(*args)
            torch.cuda.synchronize()
            want = conv_fused.fused_conv3x3_bn_relu_plain(*args)
            err = (got.float() - want.float()).abs().max().item()
            rel = err / want.float().abs().max().item()
            print(f"K2 conv3x3_bn_act {str(dtype)[6:]} {shape}: max_abs_err {err:.3e} "
                  f"rel {rel:.3e} (tol {tol:g})")
            check(rel <= tol, f"conv3x3_bn_act {dtype} {shape} rel err {rel}")
            if dtype == torch.bfloat16:
                n, h, w, cin, cout = shape
                b, kind = bound(n * h * w * (cin + cout) * 2 + 9 * cin * cout * 2
                                + cout * 8, 2 * 9 * cin * cout * n * h * w, "bf16")
                r = dict(
                    shape=f"[{n},{h},{w},{cin}]->{cout} bf16", max_abs_err=err,
                    ms=cuda_ms(lambda: conv_fused.fused_conv3x3_bn_relu(*args), 3),
                    plain_ms=cuda_ms(lambda: conv_fused.fused_conv3x3_bn_relu_plain(*args), 3),
                    bound_ms=b, bound_by=kind,
                    library_ms=cuda_ms(lambda: conv_library(*args), 3))
                print(f"K2 timing {r['shape']}: kernel {r['ms']:.4f} ms, plain "
                      f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
                      f"bound {b:.4f} ms ({kind})")
                if shape == k2_shapes[1]:
                    results["conv3x3_bn_act"] = r
            del got, want, args

    def mbconv_case(n, cin, ratio, cout, h, w, dtype):
        from enhanced_unet_tpu_torch.models import init_random_weights_
        from enhanced_unet_tpu_torch.models.encoders import MBConvBlock

        blk = MBConvBlock(cin, cout, ratio, 1, 3, fused=True, dtype=dtype)
        init_random_weights_(blk, 1).eval().to(dev)
        x = torch.randn(n, cin, h, w, generator=g, device=dev).to(dtype)
        return x, blk.fold(), blk.residual

    k1_shapes = [  # stage-0 blocks at 256^2 (512^2 input), TTA trio batch 6
        (6, 48, 1, 24, 256, 256), (6, 24, 1, 24, 256, 256),
        (6, 40, 6, 40, 128, 128),     # a stride-1 expand-6 block of B5 stage 1
    ]
    with torch.no_grad():
        for shape in k1_shapes:
            x, p, res = mbconv_case(*shape, torch.bfloat16)
            got = mbconv.mbconv_infer_nchw(x, p, residual=res)
            torch.cuda.synchronize()
            want = mbconv.mbconv_infer_nchw_plain(x, p, residual=res)
            err = (got.float() - want.float()).abs().max().item()
            rel = err / want.float().abs().max().item()
            print(f"K1 mbconv bf16 {shape} residual={res}: max_abs_err {err:.3e} "
                  f"rel {rel:.3e} (tol 2e-2)")
            check(rel <= 2e-2, f"mbconv {shape} rel err {rel}")
            n, cin, ratio, cout, h, w = shape
            mid, hw = cin * ratio, n * h * w
            sums = mbconv.mbconv_pass1(x, p)
            want1 = mbconv.mbconv_pass1_plain(x, p)
            err1 = (sums - want1).abs().max().item()
            check(err1 <= 1e-3 * want1.abs().max().item(),
                  f"mbconv pass 1 sums rel err {err1}")
            wpp = mbconv.se_gated_projection(want1, p, h * w, x.dtype)
            # per pixel: expand 2*cin*mid (+ bias, SiLU ~5*mid), depthwise
            # 18*mid (+ bias, SiLU ~5*mid); pass 1 adds the sum (mid), pass 2
            # the projection 2*mid*cout (+ bias, residual 2*cout)
            expand = ratio != 1
            ops = (2 * cin + 5) * mid * expand + 23 * mid
            w_bytes = (mid * cin * 2 + mid * 4) * expand + mid * (9 * 2 + 4)
            b1, k1 = bound(hw * cin * 2 + w_bytes + n * mid * 4,
                           hw * (ops + mid), "bf16")
            b2, k2 = bound(hw * (cin + cout) * 2 + w_bytes + n * mid * cout * 2
                           + cout * 4, hw * (ops + 2 * mid * cout + 2 * cout),
                           "bf16")
            r1 = dict(shape=f"[{n},{cin},{h},{w}] mid {mid} bf16", max_abs_err=err1,
                      ms=cuda_ms(lambda: mbconv.mbconv_pass1(x, p), 5),
                      plain_ms=cuda_ms(lambda: mbconv.mbconv_pass1_plain(x, p), 5),
                      bound_ms=b1, bound_by=k1, library_ms=None)
            r2 = dict(shape=f"[{n},{cin},{h},{w}] mid {mid} ->{cout}"
                            f"{' residual' if res else ''} bf16",
                      max_abs_err=err,
                      ms=cuda_ms(lambda: mbconv.mbconv_pass2(x, p, wpp, res), 5),
                      plain_ms=cuda_ms(lambda: mbconv.mbconv_pass2_plain(x, p, wpp, res), 5),
                      bound_ms=b2, bound_by=k2, library_ms=None)
            for name, r in (("pass 1", r1), ("pass 2", r2)):
                print(f"K1 {name} timing {r['shape']}: kernel {r['ms']:.4f} ms, plain "
                      f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                      f"({r['bound_by']})")
            if shape == k1_shapes[1]:
                results["mbconv_pass1"], results["mbconv_pass2"] = r1, r2
            del got, want, x, p, sums, want1, wpp

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
    torch.cuda.reset_peak_memory_stats()
    for k in conv_fused.LAUNCHES:
        conv_fused.LAUNCHES[k] = 0
    for k in mbconv.LAUNCHES:
        mbconv.LAUNCHES[k] = 0
    times = []
    classes_seen = set()
    for imgs in requests:
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
    launches = {**conv_fused.LAUNCHES, **mbconv.LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    print(f"slice: request ms {[round(t * 1e3, 1) for t in times]}, "
          f"peak memory {peak} bytes, launches {json.dumps(launches)}")
    check(len(classes_seen) >= 2, f"the cascade decided only {classes_seen}")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched by the serving path")
    profile_request(evaluator, requests[-1], 1e3 * min(times[1:]))

    # ---- 5. full-width cross-check against the fp32 CPU plain path ------
    x = torch.from_numpy(synthetic_images(1, 256, 7)) - 0.5
    with torch.no_grad():
        got, _ = model(x.to(dev))
        del model, evaluator
        torch.cuda.empty_cache()
        ref_model = serving_model(dtype=torch.float32, device="cpu")
        t0 = time.perf_counter()
        want, _ = ref_model(x)
    err = (got.float().cpu() - want).abs().max().item()
    scale = want.abs().max().item()
    # bf16 activations through ~90 layers against fp32: about 2^-8 relative
    # rounding per layer, partly cancelling; 5e-2 of max |logit| allows it
    print(f"cross-check 256^2: bf16 card vs fp32 cpu max_abs_err {err:.4e}, "
          f"max |logit| {scale:.4e}, ratio {err / scale:.4e} (tol 5e-2); "
          f"cpu forward {time.perf_counter() - t0:.1f} s")
    check(torch.isfinite(got).all().item(), "finite logits")
    check(err <= 5e-2 * scale, "bf16 card path within 5e-2 of max |logit|")

    # ---- 6. report -------------------------------------------------------
    meta = {
        "conv3x3_bn_act": ("enhanced_unet_tpu_torch/csrc/conv3x3_bn_act.cu",
                           "enhanced_unet_tpu/ops/pallas/conv_fused.py:109"),
        "mbconv_pass1": ("enhanced_unet_tpu_torch/csrc/mbconv.cu",
                         "enhanced_unet_tpu/ops/pallas/mbconv.py:208"),
        "mbconv_pass2": ("enhanced_unet_tpu_torch/csrc/mbconv.cu",
                         "enhanced_unet_tpu/ops/pallas/mbconv.py:233"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        r = results[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "shape": r["shape"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
