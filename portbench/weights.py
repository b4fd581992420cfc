"""Seeded weights of a run, over the reference's own parameter names and
shapes, made on the device in a few large draws and then calibrated on
seeded micrographs, so that what the model answers depends on the image.

Draws: conv kernels N(0, 1 / fan_in) (fan_in: a group's input channels
times the taps), conv biases N(0, 0.05^2), BatchNorm scales U(lo, hi) (the
configuration's `calibration.bn_scale`), shifts N(0, 0.1^2).

Calibration (`calibrate`), with the reference in fp32 on seeded micrographs
enhanced as the serving path enhances them: every BatchNorm's running mean
and variance become the statistics of its input there (one forward in
which only the BatchNorms are in train mode), so each normalises what it
sees and the image's contrast reaches the output instead of drowning in the
constant parts; a variance is floored at `VAR_FLOOR` of its layer's median,
so a channel that is nearly constant on the batch is not blown up on
another image.  A BatchNorm that sees one value a channel an image (the
ASPP's image-level pooling) keeps its drawn statistics, N(0, 0.1^2) and
U(0.75, 1.25).  Then the configuration's `output_convs` are scaled so that
the logits spread by `logit_std` (their standard deviation over the
batch's pixels, the mean over classes), and the threshold cascade makes
real decisions.  BatchNorm scales below 1 keep the network from the chaotic
regime in which bf16 rounding grows through the depth as fast as the
signal does.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Sequence

import numpy as np
import torch
import torch.nn as nn

STREAMS = {"weights": 1, "inputs": 2, "draws": 3, "sample": 4, "calibration": 5}
VAR_FLOOR = 0.1


def generator(seed: int, stream: str, device) -> torch.Generator:
    """A generator on `device` for one named stream of `seed`."""
    return torch.Generator(device=device).manual_seed(
        ((int(seed) << 3) | STREAMS[stream]) & (2 ** 63 - 1))


def spec_of(model: torch.nn.Module) -> Dict[str, torch.Size]:
    """Name -> shape of every tensor of a model's state dict."""
    return {n: t.shape for n, t in model.state_dict().items()}


def make_weights(spec: Mapping[str, torch.Size], seed: int, device) -> Dict[str, torch.Tensor]:
    gen = generator(seed, "weights", device)
    bn_prefixes = {n[:-len("running_mean")] for n in spec if n.endswith("running_mean")}
    normal, uniform = [], []          # (name, numel, scale, offset)
    out: Dict[str, torch.Tensor] = {}
    for name, shape in spec.items():
        numel = math.prod(shape)
        prefix = name.rsplit(".", 1)[0] + "."
        if name.endswith("num_batches_tracked"):
            out[name] = torch.zeros(shape, dtype=torch.long, device=device)
        elif len(shape) == 4:
            normal.append((name, numel, 1.0 / math.sqrt(math.prod(shape[1:])), 0.0))
        elif name.endswith("running_var") or (prefix in bn_prefixes and name.endswith("weight")):
            uniform.append((name, numel, 0.5, 0.75))
        elif name.endswith("running_mean") or prefix in bn_prefixes:
            normal.append((name, numel, 0.1, 0.0))
        elif name.endswith("bias"):
            normal.append((name, numel, 0.05, 0.0))
        else:
            raise ValueError(f"no rule for the weight {name} {tuple(shape)}")
    for draw, parts in ((torch.randn, normal), (torch.rand, uniform)):
        flat = draw(sum(p[1] for p in parts), generator=gen, device=device)
        scale = torch.tensor([p[2] for p in parts], device=device)
        offset = torch.tensor([p[3] for p in parts], device=device)
        counts = torch.tensor([p[1] for p in parts], device=device)
        flat = (flat * scale.repeat_interleave(counts, output_size=flat.numel())
                + offset.repeat_interleave(counts, output_size=flat.numel()))
        for (name, _, _, _), t in zip(parts, flat.split([p[1] for p in parts])):
            out[name] = t.view(spec[name])
    return {n: out[n] for n in spec}


@torch.no_grad()
def calibrate(model: nn.Module, x: torch.Tensor, output_convs: Sequence[str],
              logit_std: float, shrink: float) -> None:
    """Set `model`'s BatchNorm statistics from the NCHW batch `x` and scale
    its output convs (see the module's docstring).  `model` is left in eval
    mode."""
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    drawn = {m: (m.running_mean.clone(), m.running_var.clone()) for m in bns}
    pooled = set()

    def keep_if_pooled(mod, args):
        if args[0].shape[-2:].numel() == 1:
            pooled.add(mod)
            mod.eval()

    hooks = [m.register_forward_pre_hook(keep_if_pooled) for m in bns]
    model.eval()
    for m in bns:
        m.reset_running_stats()
        m.momentum = None                 # a cumulative mean: this batch's statistics
        m.train()
    try:
        model(x)
    finally:
        for h in hooks:
            h.remove()
        model.eval()
    for m in bns:
        m.momentum = 0.1
        if m in pooled:
            m.running_mean.copy_(drawn[m][0])
            m.running_var.copy_(drawn[m][1])
        else:
            m.running_var.clamp_(min=VAR_FLOOR * m.running_var.median().item())
            m.weight.mul_(shrink)
    logits = model(x)[0].float()
    gain = logit_std / logits.std(dim=(0, 2, 3)).mean().item()
    for name in output_convs:
        conv = model.get_submodule(name)
        conv.weight.mul_(gain)
        if conv.bias is not None:
            conv.bias.mul_(gain)
    model.get_submodule(output_convs[-1]).bias.sub_(gain * logits.mean(dim=(0, 2, 3)))


def seeded_weights(cell, seed: int, device) -> Dict[str, torch.Tensor]:
    """A cell's weights from `seed`: `make_weights` over its reference's
    names and shapes, calibrated by the reference in fp32 on the
    configuration's `calibration.images` micrographs of `calibration.size`
    pixels a side, drawn from the seed's own stream."""
    from portbench.micrographs import micrographs
    from portbench.reference import common

    cal = cell.config["calibration"]
    with torch.device("meta"):
        model = cell.reference().build(cell.config)
    model = model.to_empty(device=device)
    model.load_state_dict(make_weights(spec_of(model), seed, device))
    size = int(cal["size"])
    images, _ = micrographs(int(cal["images"]), size, size, seed, device, stream="calibration")
    x = torch.from_numpy(np.stack([common.enhance(im) for im in images.cpu().numpy()]))
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    common.plain_float32()
    try:
        calibrate(model, x.permute(0, 3, 1, 2).contiguous().to(device), cal["output_convs"],
                  float(cal["logit_std"]), float(cal["bn_shrink"]))
    finally:        # the program's window runs under the defaults
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    return {n: t.detach().clone() for n, t in model.state_dict().items()}
