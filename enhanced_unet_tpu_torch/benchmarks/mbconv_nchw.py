"""K1's `nchw` kernels (`csrc/mbconv.cu`) on the card, pass by pass, at the
shapes they serve: B2's bf16 passes, the fp32 blocks of stages 0 and 1 and
the bf16 blocks of stages 3 and 6.

    python -m enhanced_unet_tpu_torch.benchmarks.mbconv_nchw [--sweep | --ablate]

Prints one JSON row a pass and shape: each pass checked against its plain
version (pass 1's sums within 1e-3 of max |value|, pass 2 within 2e-2 in
bf16 and 1e-4 in fp32), then `ms` (held), `wall_ms` (unheld), `plain_ms`
and `library_block_ms`: the library's channels_last block on the same
values (`mbconv_proto.mbconv_nhwc_library`, several PyTorch calls for both
passes and the gate; the same on both rows of a shape).

`--sweep` times two of the source's constants instead: the blocks an SM
that pass 2's register cap leaves room for without an expand
(`MBCONV_P2_BLOCKS`) and the widest bf16 map that takes 32 x 8 tiles rather
than 64 x 4 (`MBCONV_NARROW_W`; 0: every map 64 wide, 4096: every map 32
wide).  It builds the committed source once per setting in `VARIANTS` (the
constants as `-D` flags) into `build/mbconv_nchw_sweep/`, all together (one
`nvcc` each, each kernel's registers and spills from `ptxas -v`), and checks
and times each at every case, the variants in order and then in reverse.

`--ablate` times pass 2 at the cases without an expand with one of its
phases left out (`ABLATIONS`, `-DMBCONV_SKIP=..`: the input copies, the
depthwise, the projection's GEMM, the epilogue and stores), built and timed
the same way; the results are wrong by construction, so these rows are not
checked.  What a phase's removal saves is an upper bound on its share.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from typing import Dict, List, Optional, Union

import torch

from enhanced_unet_tpu_torch.benchmarks.mbconv_proto import (
    make_params,
    mbconv_nhwc_library,
    proto_weights,
)
from enhanced_unet_tpu_torch.benchmarks.microtime import device_ms, device_row, kernel_row
from enhanced_unet_tpu_torch.device import resolve_device
from enhanced_unet_tpu_torch.ops.kernels import build, mbconv

BF16, FP32 = torch.bfloat16, torch.float32
# (name, n, cin, mid, cout, h, w, residual, dtype)
CASES = (
    ("b2", 16, 24, 24, 24, 256, 256, True, BF16),
    ("stage1_fp32", 6, 40, 240, 40, 128, 128, True, FP32),
    ("stage0_48_fp32", 6, 48, 48, 24, 256, 256, False, FP32),
    ("stage0_24_fp32", 6, 24, 24, 24, 256, 256, True, FP32),
    ("stage3_bf16", 6, 128, 768, 128, 32, 32, True, BF16),
    ("stage6_bf16", 6, 512, 3072, 512, 16, 16, True, BF16),
)
SUMS_TOL = 1e-3
ITERS = 20
# settings of the source's constants (`-D` flags); the first is the
# committed setting
VARIANTS: List[Dict[str, int]] = [
    {"MBCONV_P2_BLOCKS": 2, "MBCONV_NARROW_W": 32},
    {"MBCONV_P2_BLOCKS": 2, "MBCONV_NARROW_W": 0},
    {"MBCONV_P2_BLOCKS": 2, "MBCONV_NARROW_W": 4096},
    {"MBCONV_P2_BLOCKS": 3, "MBCONV_NARROW_W": 32}]
SWEEP_DIR = build.BUILD_DIR.parent / "mbconv_nchw_sweep"
# pass 2's phases left out: MBCONV_SKIP's bits (csrc/mbconv.cu's `Skip`)
ABLATIONS: Dict[str, int] = {"all": 0, "no_copies": 1, "no_depthwise": 2, "no_gemm": 4,
                             "no_stores": 8}


def run_case(name: str, n: int, cin: int, mid: int, cout: int, h: int, w: int,
             residual: bool, dtype: torch.dtype, device: torch.device) -> List[dict]:
    g = torch.Generator(device=device).manual_seed(0)
    params = make_params(g, cin, mid, cout, max(1, cin // 4))
    params = {k: v.to(dtype) if k in ("wexp", "wdw") else v for k, v in params.items()}
    p = proto_weights(params, mid != cin)
    x = (torch.randn(n, cin, h, w, generator=g, device=device) * 0.5).to(dtype)
    wpp = mbconv.se_gated_projection(mbconv.mbconv_pass1_plain(x, p), p, h * w, dtype)
    xh = x.permute(0, 2, 3, 1).contiguous()
    block = device_ms(lambda: mbconv_nhwc_library(xh, params, expand=mid != cin,
                                                  residual=residual), ITERS)
    tol = 2e-2 if dtype == BF16 else 1e-4
    rows = []
    for which, kernel, plain, t in (
            ("pass1", lambda: mbconv.mbconv_pass1(x, p),
             lambda: mbconv.mbconv_pass1_plain(x, p), SUMS_TOL),
            ("pass2", lambda: mbconv.mbconv_pass2(x, p, wpp, residual),
             lambda: mbconv.mbconv_pass2_plain(x, p, wpp, residual), tol)):
        row = kernel_row(f"{name} {which}", kernel, plain, t, iters=ITERS)
        row.update(shape=f"[{n},{cin},{h},{w}] mid {mid} ->{cout}"
                         f"{' residual' if residual else ''} {str(dtype)[6:]}",
                   library_block_ms=block)
        rows.append(row)
    return rows


def registers(ptxas_log: str) -> Dict[str, str]:
    """Registers and spill bytes a thread of each tiled kernel instantiation,
    from `ptxas -v`: `bf16`/`fp32`, `expand`/`plain`, `pass1`/`pass2`,
    `vec`/`elt`, tile width, Cout block."""
    found = re.findall(
        r"Compiling entry function '\S*mbconv_nchw_kernelILb(\d)ELi(\d+)ELb(\d)ELi(\d)ELb(\d)E"
        r"Li(\d+)E\S*'[^\n]*\n(?:[^\n]*\n)*?[^\n]*?(\d+) bytes spill stores[^\n]*\n"
        r"[^\n]*Used (\d+) registers", ptxas_log)
    return {f"{'bf16' if b == '1' else 'fp32'} {'expand' if e == '1' else 'plain'} pass{p} "
            f"{'vec' if v == '1' else 'elt'} tw{tw} ct{ct}": f"{regs} regs, {spill} B spilled"
            for b, tw, e, p, v, ct, spill, regs in found}


def build_variants(settings: Dict[str, Dict[str, int]]) -> Dict[str, tuple]:
    """One library per setting of `csrc/mbconv.cu`'s macros (by name), the
    committed source built together with each as `-D` flags; returns each
    one's (path, ptxas log).  Raises if a build fails."""
    SWEEP_DIR.mkdir(parents=True, exist_ok=True)
    tag = build.library_path("mbconv").stem.split("-")[-1]
    procs = {}
    for key, macros in settings.items():
        out = SWEEP_DIR / f"libmbconv-{tag}-{key}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v",
               *(f"-D{name}={value}" for name, value in macros.items()),
               "-o", str(out), str(build.CSRC / "mbconv.cu")]
        procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True), out)
    built = {}
    for key, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the setting {key}:\n{log}")
        built[key] = (out, log)
    return built


def sweep(device: Optional[Union[str, torch.device]] = None) -> List[dict]:
    """The compile-time settings at every case, on the card, the variants
    in order and then in reverse."""
    device = resolve_device(device)
    rows = [device_row(device)]
    print(json.dumps(rows[0]), flush=True)
    built = build_variants({str(i): v for i, v in enumerate(VARIANTS)})
    libs = {int(key): mbconv.bind_nchw(ctypes.CDLL(str(path)))
            for key, (path, _) in built.items()}
    order = list(range(len(VARIANTS))) + list(reversed(range(len(VARIANTS))))
    committed = mbconv._lib
    try:
        with torch.no_grad():
            for i, key in enumerate(order):
                mbconv._lib = lambda lib=libs[key]: lib
                row = {"variant": VARIANTS[key],
                       "round": 0 if i < len(VARIANTS) else 1}
                if row["round"] == 0:
                    row["registers"] = registers(built[str(key)][1])
                for case in CASES:
                    for r in run_case(*case, device=device):
                        row[r["bench"]] = r["ms"]
                rows.append(row)
                print(json.dumps(row), flush=True)
    finally:
        mbconv._lib = committed
    return rows


def ablate(device: Optional[Union[str, torch.device]] = None) -> List[dict]:
    """Pass 2 at the cases without an expand with each of its phases taken
    out, on the card, unchecked; the ablations in order, then in reverse."""
    device = resolve_device(device)
    rows = [device_row(device)]
    print(json.dumps(rows[0]), flush=True)
    built = build_variants({k: {"MBCONV_SKIP": v} for k, v in ABLATIONS.items()})
    libs = {k: mbconv.bind_nchw(ctypes.CDLL(str(path))) for k, (path, _) in built.items()}
    committed = mbconv._lib
    try:
        with torch.no_grad():
            for name, n, cin, mid, cout, h, w, residual, dtype in CASES:
                if mid != cin:
                    continue
                g = torch.Generator(device=device).manual_seed(0)
                params = make_params(g, cin, mid, cout, max(1, cin // 4))
                params = {k: v.to(dtype) if k in ("wexp", "wdw") else v
                          for k, v in params.items()}
                p = proto_weights(params, False)
                x = (torch.randn(n, cin, h, w, generator=g, device=device) * 0.5).to(dtype)
                wpp = params["wproj"].to(dtype)[None].expand(n, cin, cout).contiguous()
                row = {"bench": f"{name} pass2 ablation"}
                for k in list(ABLATIONS) + list(reversed(ABLATIONS)):
                    mbconv._lib = lambda lib=libs[k]: lib
                    row.setdefault(k, []).append(device_ms(
                        lambda: mbconv.mbconv_pass2(x, p, wpp, residual), ITERS))
                rows.append(row)
                print(json.dumps(row), flush=True)
    finally:
        mbconv._lib = committed
    return rows


def main(device: Optional[Union[str, torch.device]] = None) -> List[dict]:
    """Every row on the card (`device=None`), or raise without one."""
    device = resolve_device(device)
    rows = [device_row(device)]
    print(json.dumps(rows[0]), flush=True)
    with torch.no_grad():
        for case in CASES:
            for row in run_case(*case, device=device):
                rows.append(row)
                print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sweep", action="store_true", help="time the constants' settings")
    parser.add_argument("--ablate", action="store_true", help="time pass 2 without each phase")
    args = parser.parse_args()
    (sweep if args.sweep else ablate if args.ablate else main)()
