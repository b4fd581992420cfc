"""Time each hand-written kernel alone at the shapes one served request
gives it, on one CUDA card.

    python3 kernel_times.py

For each cell of `BENCHMARK.json` whose traffic serves requests it sets
the cell up as the benchmark does (`portbench.harness.Cell` and the
kind's own `Workload.setup`: the cell's model, dtype, seeded weights,
Evaluator and micrographs; one warm-up request) and serves one request
of the pool under a `Recorder`.  Other cells are skipped, each named on a
line of its own.  The recorder sees every call of the hand-written
kernels' entry points where the models look them up:

    K2  3x3 conv + BN + ReLU         models.blocks    fused_conv3x3_bn_relu_packed
    K1  the fused MBConv (2 passes)  models.encoders  mbconv_infer_nchw
    D1  dilated depthwise + BN + SiLU  models.encoders  dw_dilated_bn_silu_nhwc
    D2  depthwise 3x3 + bias + GELU  models.segformer dw3x3_bias_gelu_nhwc
    S1  scSE over channel parts      models.blocks    scse_parts

and the calls it saw must equal what the kernels' launch counters counted
over the request (K1: one pass 1 and one pass 2 a call).  Then each
distinct call is run alone on seeded inputs of its shape and layout with
the weights the request used: checked against its plain version (2e-2 of
max |value| in bf16, 1e-4 in fp32), and timed with
`benchmarks/microtime.device_ms` held (`ms`) and unheld (`wall_ms`),
beside the plain version (`plain_wall_ms`, unheld: cuDNN's fp32 convs in
K2's plain version block the host for up to about 0.4 s a call, which the
held timer refuses) and the least time the card could take
(`bound_ms`).  The plain version and the check run in chunks of images:
the fusion head's calls write 5.0e9 elements, whose fp32 copies would not
fit beside them.

Bounds: K2 and K1 (the sum of the two passes') from
`portbench/counts/kernels.py`, D2 from `portbench/counts/tokens.py`; D1
and S1 through the same `bound_s`, their operands read once and the output
written once.

Prints the card line, one JSON row per (cell, kernel, shape) with its
launches a request and the SM clock, temperature and power that
`nvidia-smi` reads just after its timings (a throttled card reads slow),
and one row per (cell, kernel) with the sums over the request (each
shape's times its launches).  Raises without a card: a CPU
gives no device time.
"""

from __future__ import annotations

import json
import subprocess
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Tuple

import torch

from enhanced_unet_tpu_torch.benchmarks.microtime import device_ms, device_row
from enhanced_unet_tpu_torch.models import blocks, encoders, segformer
from enhanced_unet_tpu_torch.ops.kernels import conv_fused, depthwise, mbconv, scse
from portbench import harness
from portbench.counts.kernels import bound_s, k1_pass_bound_s, k2_bound_s
from portbench.counts.tokens import dw_gelu_bound_s

ROOT = Path(__file__).resolve().parent
PLAIN_ELEMENTS = 2 ** 30       # elements of an input or output a chunk of the plain version


class Call(NamedTuple):
    """One distinct kernel call: its inputs' (shape, stride, dtype), the
    kernel and its plain version on such inputs (the weights bound in),
    and its bound in seconds."""
    inputs: List[Tuple[tuple, tuple, torch.dtype]]
    kernel: Callable[..., torch.Tensor]
    plain: Callable[..., torch.Tensor]
    bound_s: float


def _layout(t: torch.Tensor):
    return tuple(t.shape), t.stride(), t.dtype


def _k2(x, packed, relu=True):
    n, h, w, cin = x.shape
    return (f"[{n},{h},{w},{cin}]->{packed.cout} {packed.variant}" + ("" if relu else " no relu"),
            Call([_layout(x)], lambda x: conv_fused.fused_conv3x3_bn_relu_packed(x, packed, relu),
                 lambda x: conv_fused.fused_conv3x3_bn_relu_plain(
                     x, packed.w.permute(1, 2, 3, 0), packed.scale, packed.shift, relu),
                 k2_bound_s(n, h, w, cin, packed.cout, x.element_size())))


def _k1(x, p, *, residual):
    n, cin, h, w = x.shape
    mid, cout, expand = p.wdw.shape[0], p.wproj.shape[1], p.wexp is not None
    return (f"[{n},{cin},{h},{w}] mid {mid}->{cout}" + (" residual" if residual else ""),
            Call([_layout(x)], lambda x: mbconv.mbconv_infer_nchw(x, p, residual=residual),
                 lambda x: mbconv.mbconv_infer_nchw_plain(x, p, residual=residual),
                 sum(k1_pass_bound_s(which, n, cin, h, w, mid, cout, expand, x.element_size())
                     for which in (1, 2))))


def _d1(x, p, dilation):
    n, c, h, w = x.shape
    k, es = p.w.shape[0], x.element_size()
    return (f"[{n},{c},{h},{w}] k{k} d{dilation}",
            Call([_layout(x)], lambda x: depthwise.dw_dilated_bn_silu_nhwc(x, p, dilation),
                 lambda x: depthwise.dw_dilated_bn_silu_nhwc_plain(x, p, dilation),
                 # x read and the output written once, the folded weights and
                 # the fp32 shift; k*k multiply-adds, the shift and SiLU ~5
                 bound_s(2 * n * c * h * w * es + k * k * c * es + 4 * c,
                         n * c * h * w * (2 * k * k + 5), "fp32")))


def _d2(x, p):
    n, c, h, w = x.shape
    return (f"[{n},{c},{h},{w}]",
            Call([_layout(x)], lambda x: depthwise.dw3x3_bias_gelu_nhwc(x, p),
                 lambda x: depthwise.dw3x3_bias_gelu_nhwc_plain(x, p),
                 dw_gelu_bound_s(n, h, w, c, x.element_size())))


def _s1(parts, up, p):
    n, h = parts[0].shape[0], parts[0].shape[2] * (2 if up else 1)
    w, c = parts[0].shape[3] * (2 if up else 1), sum(t.shape[1] for t in parts)
    widths = "+".join(str(t.shape[1]) for t in parts)
    return (f"[{n},{widths},{h},{w}]" + (" up" if up else ""),
            Call([_layout(t) for t in parts], lambda *parts: scse.scse_parts(parts, up, p),
                 lambda *parts: scse.scse_parts_plain(parts, up, p),
                 # the parts read once (the upsampled one at its own size), the
                 # output written once; the sSE's multiply-add and the two
                 # gates' products and sum ~5 an output element
                 bound_s((sum(t.numel() for t in parts) + n * c * h * w)
                         * parts[0].element_size(), 5 * n * c * h * w, "fp32")))


# kernel -> (the module the models look its entry up in, the entry's name,
# the call's shape and `Call`)
KERNELS = {"K2": (blocks, "fused_conv3x3_bn_relu_packed", _k2),
           "K1": (encoders, "mbconv_infer_nchw", _k1),
           "D1": (encoders, "dw_dilated_bn_silu_nhwc", _d1),
           "D2": (segformer, "dw3x3_bias_gelu_nhwc", _d2),
           "S1": (blocks, "scse_parts", _s1)}


class Recorder:
    """While installed, records every call of the entries in `KERNELS`:
    `calls[kernel][shape]` = [calls, `Call`], in the order first seen."""

    def __init__(self):
        self.calls: Dict[str, Dict[str, list]] = {k: {} for k in KERNELS}
        self._restore = []
        for kernel, (module, name, describe) in KERNELS.items():
            fn = getattr(module, name)
            self._restore.append((module, name, fn))
            setattr(module, name, self._recording(self.calls[kernel], fn, describe))

    @staticmethod
    def _recording(calls, fn, describe):
        def recording(*args, **kwargs):
            shape, call = describe(*args, **kwargs)
            calls.setdefault(shape, [0, call])[0] += 1
            return fn(*args, **kwargs)
        return recording

    def remove(self) -> None:
        for module, name, fn in reversed(self._restore):
            setattr(module, name, fn)
        self._restore.clear()

    def launches(self) -> Dict[str, int]:
        return {k: sum(c for c, _ in by_shape.values()) for k, by_shape in self.calls.items()}


def record(serve: Callable[[], object]) -> Recorder:
    """Calls `serve()` (one request) with a `Recorder` installed; returns
    it, removed."""
    rec = Recorder()
    try:
        serve()
    finally:
        rec.remove()
    return rec


def served_cells(bench: dict, base: Path = ROOT / "portbench") -> list:
    """The cells of the manifest `bench` whose kind serves requests (its
    `Workload` has `serve`), each with its kind's `Workload`; prints a line
    naming each other cell, skipped."""
    cells = []
    for workload in bench["workloads"]:
        cell = harness.Cell(bench, workload["name"], base)
        kind = cell.kind_module()
        if hasattr(kind.Workload, "serve"):
            cells.append((cell, kind.Workload))
        else:
            print(json.dumps({"cell": cell.name, "skipped": f"its kind {cell.kind!r} serves "
                              "no request"}), flush=True)
    return cells


def _counted() -> Dict[str, int]:
    """The kernels' launch counters (K1's: both passes)."""
    return {"K2": sum(conv_fused.LAUNCHES.values()), "K1": sum(mbconv.LAUNCHES.values()),
            "D1": depthwise.LAUNCHES["dw_dilated_bn_silu_nhwc"],
            "D2": depthwise.LAUNCHES["dw3x3_bias_gelu_nhwc"], "S1": scse.LAUNCHES["scse_parts"]}


def time_call(call: Call, g: torch.Generator) -> dict:
    """`call` alone on seeded inputs: its error against the plain version
    (raises above the dtype's tolerance) and its times."""
    xs = [torch.empty_strided(shape, stride, dtype=dtype, device=g.device).normal_(
        0.0, 0.5, generator=g) for shape, stride, dtype in call.inputs]
    got = call.kernel(*xs)
    per_image = max([got[0].numel()] + [x[0].numel() for x in xs])
    step = max(1, PLAIN_ELEMENTS // per_image)
    chunks = [[x[i:i + step] for x in xs] for i in range(0, got.shape[0], step)]
    err = ref = 0.0
    for i, chunk in zip(range(0, got.shape[0], step), chunks):
        want = call.plain(*chunk).float()
        err = max(err, (got[i:i + step].float() - want).abs().max().item())
        ref = max(ref, want.abs().max().item())
        del want
    rel = err / max(ref, 1e-6)
    tol = 2e-2 if got.dtype == torch.bfloat16 else 1e-4
    if not rel <= tol:
        raise RuntimeError(f"the kernel differs from its plain version by {rel:.3e} of max "
                           f"|value| (tolerance {tol})")
    del got
    return {"rel_err": rel, "ms": device_ms(lambda: call.kernel(*xs)),
            "wall_ms": device_ms(lambda: call.kernel(*xs), held=False),
            "plain_wall_ms": device_ms(lambda: [call.plain(*c) for c in chunks], held=False),
            "bound_ms": call.bound_s * 1e3}


def _smi(fields: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def card_line() -> str:
    return _smi("name,power.limit")


def card_state() -> dict:
    """The SM clock, temperature and power draw now."""
    return dict(zip(("sm_clock", "temperature_c", "power"),
                    (v.strip() for v in _smi("clocks.sm,temperature.gpu,power.draw").split(","))))


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_times.py times kernels on a CUDA card, and there is none")
    torch.backends.cudnn.allow_tf32 = False           # the plain versions' sums in fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(json.dumps({"card": card_line(), **device_row(dev), "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    for cell, workload in served_cells(harness.manifest(ROOT)):
        work = workload(cell, 0, dev)
        work.setup()
        before = _counted()
        rec = record(lambda: work.serve(0))
        counted = {k: v - before[k] for k, v in _counted().items()}
        seen = {k: v * (2 if k == "K1" else 1) for k, v in rec.launches().items()}
        if seen != counted:
            raise RuntimeError(f"{cell.name}: the recorder saw {seen} launches, the "
                               f"counters counted {counted}")
        work.release()
        del work
        torch.cuda.empty_cache()
        g = torch.Generator(device=dev).manual_seed(0)
        for kernel, by_shape in rec.calls.items():
            total = dict.fromkeys(("ms", "wall_ms", "plain_wall_ms", "bound_ms"), 0.0)
            for shape, (launches, call) in by_shape.items():
                row = {"cell": cell.name, "kernel": kernel, "shape": shape,
                       "launches": launches, **time_call(call, g), **card_state()}
                print(json.dumps(row), flush=True)
                for key in total:
                    total[key] += row[key] * launches
            if by_shape:
                print(json.dumps({"cell": cell.name, "kernel": kernel, "shape": "sum",
                                  "launches": rec.launches()[kernel], **total}), flush=True)
            by_shape.clear()
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
