"""Serving, as `serve.py` serves (one client in a closed loop, the same
requests, window and comparison), for a configuration whose reference has
token layers: linears, LayerNorms and attention (SegFormer).  Three things
differ from `serve.Workload`:

- `weights()`: every 2-D linear weight is drawn N(0, 1 / in_features), each
  LayerNorm's scale U(0.75, 1.25) and shift N(0, 0.1^2) (found by the
  reference's module types, not by name), from the seed's `draws` stream;
  the rest (convs, biases, the BatchNorm) as `weights.make_weights` draws
  them.  Then, on the calibration micrographs, the bias of each conv that
  the configuration's `calibration.center_convs` names is set so that the
  conv's output has zero mean a channel (`center`), and `weights.calibrate`
  runs as `weights.seeded_weights` runs it.  Last, every floating tensor is
  rounded to the configuration's `dtype` (bf16) and kept in fp32: the
  weights are a bf16 checkpoint's, which the program serves as they are and
  the reference computes on exactly, so the comparison measures the
  program's arithmetic.  Rounding fp32 draws in the program alone moves
  the function by a fixed amount a seed, whose size varies several times
  from seed to seed and which no bf16 program can avoid (on the CPU, B5 at
  256^2: fp32 arithmetic on the rounded weights gave the bf16 program's
  whole gap to the reference, 0.155 against 0.153 and 0.185 against
  0.173; on exact weights the program's gap fell to 0.059-0.062 and the
  fp8 control's stayed at 1.2-3.0).
- `reference(precision)`: the control also rounds the reference's linears
  and attention products through fp8 (`set_token_precision`).
- `install_counters()`: `counters.KernelCalls` and records of the calls of
  the model's Mix-FFN depthwise kernel, (n, h, w, c, element size), and of
  its attention, (n, heads, Lq, Lk, d, element size), for the per-layer
  metrics of `portbench/tokenread.py`.  A program without the model's
  module records none of them.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict

import numpy as np
import torch
import torch.nn as nn

from portbench import harness, weights as W
from portbench.counters import KernelCalls
from portbench.micrographs import micrographs
from portbench.reference import common

serve = harness.module_at(Path(__file__).with_name("serve.py"), "portbench_kind_serve")


def draw(parts, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """name -> t for each (name, shape, law, scale, offset) of `parts`, law
    "normal" (scale * N(0, 1) + offset) or "uniform" (scale * U(0, 1) +
    offset), one draw of each law for them all."""
    out = {}
    for law, fn in (("normal", torch.randn), ("uniform", torch.rand)):
        group = [p for p in parts if p[2] == law]
        if not group:
            continue
        counts = [math.prod(p[1]) for p in group]
        flat = fn(sum(counts), generator=gen, device=device)
        for (name, shape, _, scale, offset), t in zip(group, flat.split(counts)):
            out[name] = (t * scale + offset).view(shape)
    return out


@torch.no_grad()
def center(model: nn.Module, x: torch.Tensor, convs) -> None:
    """Subtract from the bias of each conv of `convs` (names in `model`, in
    the order the forward reaches them) the mean a channel of its output on
    the NCHW batch `x`.  On the first patch embedding this stands in for
    what training makes of it: the model normalises its input as
    SegFormer's image processor does, but a micrograph, dark and even,
    keeps a mean level there 4-5 times its variation (-1.66, -1.58, -1.37
    against 0.33-0.35 a channel on the calibration micrographs), which
    random filters, unlike a trained network's edge and texture filters,
    pass on to every token as one vector; the head's BatchNorm, calibrated
    on the pixels' own variation, then magnifies its rounding (on the CPU,
    B5 at 256^2 on bf16-exact weights: the bf16 program's gap to the
    reference 0.178-0.212 without centring, 0.059-0.062 with it)."""
    hooks = []

    def centred(mod, args, out):
        mean = out.mean(dim=(0, 2, 3))
        mod.bias.sub_(mean)
        return out - mean[None, :, None, None]

    for name in convs:
        hooks.append(model.get_submodule(name).register_forward_hook(centred))
    try:
        model.eval()(x)
    finally:
        for h in hooks:
            h.remove()


def token_weights(cell, seed: int, device) -> Dict[str, torch.Tensor]:
    """A cell's weights from `seed` (see the module's docstring): the
    calibrated draws rounded to the configuration's dtype, kept in fp32."""
    dtype = getattr(torch, cell.config["dtype"])
    return {n: t.to(dtype).to(t.dtype) if t.is_floating_point() else t
            for n, t in calibrated_weights(cell, seed, device).items()}


def calibrated_weights(cell, seed: int, device) -> Dict[str, torch.Tensor]:
    """A cell's weights from `seed`, drawn and calibrated, in fp32."""
    cal = cell.config["calibration"]
    with torch.device("meta"):
        model = cell.reference().build(cell.config)
    model = model.to_empty(device=device)
    spec = W.spec_of(model)
    parts, rest = [], {}
    linears = {f"{n}.weight": m.in_features for n, m in model.named_modules()
               if isinstance(m, nn.Linear)}
    norms = {n for n, m in model.named_modules() if isinstance(m, nn.LayerNorm)}
    for name, shape in spec.items():
        owner, leaf = name.rsplit(".", 1)
        if name in linears:
            parts.append((name, shape, "normal", 1.0 / math.sqrt(linears[name]), 0.0))
        elif owner in norms:
            parts.append((name, shape, "uniform", 0.5, 0.75) if leaf == "weight"
                         else (name, shape, "normal", 0.1, 0.0))
        else:
            rest[name] = shape
    state = {**W.make_weights(rest, seed, device),
             **draw(parts, W.generator(seed, "draws", device), device)}
    model.load_state_dict(state)
    size = int(cal["size"])
    images, _ = micrographs(int(cal["images"]), size, size, seed, device, stream="calibration")
    x = torch.from_numpy(np.stack([common.enhance(im) for im in images.cpu().numpy()]))
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    common.plain_float32()
    try:
        x = x.permute(0, 3, 1, 2).contiguous().to(device)
        center(model, x, cal.get("center_convs", ()))
        W.calibrate(model, x, cal["output_convs"], float(cal["logit_std"]),
                    float(cal["bn_shrink"]))
    finally:        # the program's window runs under the defaults
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    return {n: t.detach().clone() for n, t in model.state_dict().items()}


class TokenCalls:
    """`KernelCalls`, and the Mix-FFN depthwise kernel's calls as (n, h, w,
    c, element size) and the attention calls as (n, heads, Lq, Lk, d,
    element size), recorded by wrappers on the names that
    `enhanced_unet_tpu_torch.models.segformer` calls."""

    def __init__(self):
        self.kernels = KernelCalls()
        self.dw, self.attention = [], []
        self._restore = []
        try:
            from enhanced_unet_tpu_torch.models import segformer
        except ImportError:                     # a program without the model
            return
        dw, attention = segformer.dw3x3_bias_gelu_nhwc, segformer.efficient_attention

        def recording_dw(x, p):
            n, c, h, w = x.shape
            self.dw.append((n, h, w, c, x.element_size()))
            return dw(x, p)

        def recording_attention(q, k, v):
            n, heads, lq, d = q.shape
            self.attention.append((n, heads, lq, k.shape[2], d, q.element_size()))
            return attention(q, k, v)

        for name, fn in (("dw3x3_bias_gelu_nhwc", recording_dw),
                         ("efficient_attention", recording_attention)):
            self._restore.append((segformer, name, getattr(segformer, name)))
            setattr(segformer, name, fn)

    def remove(self) -> None:
        for mod, name, fn in reversed(self._restore):
            setattr(mod, name, fn)
        self._restore.clear()
        self.kernels.remove()

    def counts(self) -> dict:
        return {**self.kernels.counts(), "dw_gelu_calls": list(self.dw),
                "attention_calls": list(self.attention)}


class Workload(serve.Workload):
    def weights(self) -> Dict[str, torch.Tensor]:
        """The run's weights (made once, kept on the host)."""
        if self._weights is None:
            self._weights = {n: t.cpu() for n, t in
                             token_weights(self.cell, self.seed, self.device).items()}
        return self._weights

    def reference(self, precision: str) -> torch.nn.Module:
        return self.cell.reference().set_token_precision(super().reference(precision),
                                                         precision)

    def install_counters(self) -> TokenCalls:
        return TokenCalls()
