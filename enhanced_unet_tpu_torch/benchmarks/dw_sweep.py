"""The depthwise kernels' launch constants, timed on the card.

    python -m enhanced_unet_tpu_torch.benchmarks.dw_sweep

`csrc/depthwise.cu` fixes three constants: `NT` threads a block, `SH`
output rows a strip and `PF` rows in flight a warp.  This script builds the
source once per setting in `VARIANTS` (the constants rewritten, everything
else as committed; one `nvcc` each, all started together, into
`build/dw_sweep/`, with each kernel's registers from `ptxas -v`), checks both kernels of every build against their plain
versions at [16,24,256,256] bf16, bh 32 (raises above `TOL`), and times
them with `microtime.device_ms` (held), the variants in order and then in
reverse, beside the copy kernel on the same bytes.  The kernels are called
through the C interface with bf16 weights, so no cast kernel is timed.
Prints the device row, then one JSON row a variant.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import re
import subprocess
from typing import Dict, List, Optional, Tuple, Union

import torch

from enhanced_unet_tpu_torch.benchmarks.microtime import device_ms, device_row, rel_err
from enhanced_unet_tpu_torch.device import resolve_device
from enhanced_unet_tpu_torch.ops.kernels import build, copy, depthwise

N, C, H, W, BH = 16, 24, 256, 256, 32
TOL = 2e-2
# (NT, SH, PF); the first is the committed setting
VARIANTS: List[Tuple[int, int, int]] = [(256, 16, 8), (256, 32, 8), (256, 64, 8),
                                        (128, 16, 8), (256, 16, 4)]
SWEEP_DIR = build.BUILD_DIR.parent / "dw_sweep"


def variant_source(nt: int, sh: int, pf: int) -> str:
    """`csrc/depthwise.cu` with its three constants set; raises if the
    source no longer declares each of them once."""
    src = (build.CSRC / "depthwise.cu").read_text()
    for name, value in (("NT", nt), ("SH", sh), ("PF", pf)):
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                         src)
        if n != 1:
            raise RuntimeError(f"depthwise.cu declares `constexpr int {name}` {n} times")
    return src


def registers(ptxas_log: str) -> Dict[str, int]:
    """Registers a thread of each kernel instantiation, from `ptxas -v`:
    `dw3x3`/`dw_rows` and `vec` (16-byte path) or `scalar`."""
    found = re.findall(r"Compiling entry function '\S*dw_stream_kernelILb(\d)ELb(\d)E\S*'"
                       r"[^\n]*\n(?:[^\n]*\n)*?[^\n]*Used (\d+) registers", ptxas_log)
    return {f"{'dw_rows' if rows == '1' else 'dw3x3'}_{'vec' if vec == '1' else 'scalar'}":
            int(n) for rows, vec, n in found}


def build_variants(variants: List[Tuple[int, int, int]]
                   ) -> Dict[Tuple[int, int, int], Tuple[ctypes.CDLL, Dict[str, int]]]:
    """One library a variant, built in parallel and loaded, with its
    kernels' registers a thread (empty for a library built earlier)."""
    SWEEP_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for v in variants:
        src = variant_source(*v)
        digest = hashlib.sha256(src.encode()).hexdigest()[:12]
        cu = SWEEP_DIR / f"dw_nt{v[0]}_sh{v[1]}_pf{v[2]}-{digest}.cu"
        lib = cu.with_suffix(".so")
        proc = None
        if not lib.exists():
            cu.write_text(src)
            proc = subprocess.Popen([build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v",
                                     "-o", str(lib), str(cu)],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs[v] = (proc, lib)
    libs = {}
    for v, (proc, lib) in procs.items():
        log = ""
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for variant {v}:\n{log}")
        cdll = ctypes.CDLL(str(lib))
        vp, i = ctypes.c_void_p, ctypes.c_int
        cdll.dw3x3_bias_silu.argtypes = [vp] * 4 + [i] * 4 + [vp]
        cdll.dw3x3_bias_silu.restype = i
        cdll.dw_rows_silu.argtypes = [vp] * 4 + [i] * 5 + [vp]
        cdll.dw_rows_silu.restype = i
        libs[v] = (cdll, registers(log))
    return libs


def main(device: Optional[Union[str, torch.device]] = None) -> List[dict]:
    """The sweep on the card (`device=None`), or raise without one."""
    device = resolve_device(device)
    rows = [device_row(device)]
    print(json.dumps(rows[0]), flush=True)
    libs = build_variants(VARIANTS)
    g = torch.Generator(device=device).manual_seed(0)
    x = (torch.randn(N, C, H, W, generator=g, device=device) * 0.5).to(torch.bfloat16)
    w = (torch.randn(C, 3, 3, generator=g, device=device) * 0.1).to(torch.bfloat16)
    b = torch.randn(C, generator=g, device=device) * 0.1
    out = torch.empty_like(x)
    stream = build.stream_ptr(device)
    args = (build.ptr(x), build.ptr(w), build.ptr(b), build.ptr(out), N, C, H, W)

    def call(lib: ctypes.CDLL, kernel: str):
        if kernel == "dw3x3":
            return lambda: build.check(lib.dw3x3_bias_silu(*args, stream), "dw3x3_bias_silu")
        return lambda: build.check(lib.dw_rows_silu(*args, BH, stream), "dw_rows_silu")

    plain = {"dw3x3": depthwise.dw3x3_bias_silu_plain(x, w, b),
             "dw_rows": depthwise.dw_rows_silu_plain(x, w, b, BH)}
    errs = {}
    for v, (lib, _) in libs.items():
        for kernel, want in plain.items():
            out.zero_()
            call(lib, kernel)()
            torch.cuda.synchronize()
            errs[v, kernel] = rel_err(out, want)
            if errs[v, kernel] > TOL:
                raise RuntimeError(f"variant {v} {kernel}: rel err {errs[v, kernel]}")
    times: Dict[Tuple[Tuple[int, int, int], str], List[float]] = {}
    for order in (VARIANTS, VARIANTS[::-1]):
        for v in order:
            for kernel in plain:
                times.setdefault((v, kernel), []).append(device_ms(call(libs[v][0], kernel), 30))
    copy_ms = device_ms(lambda: copy.copy(x), 30)
    for v in VARIANTS:
        row = {"nt": v[0], "sh": v[1], "pf": v[2], "shape": [N, C, H, W], "bh": BH,
               "copy_ms": copy_ms, "registers": libs[v][1]}
        for kernel in plain:
            row[f"{kernel}_ms"] = times[v, kernel]
            row[f"{kernel}_rel_err"] = errs[v, kernel]
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
