"""Plain pieces shared by the benchmark's references: a conv that can run
in the control's lower precision, the inference preprocessing (LAB CLAHE on
the L channel, clip 2.0, 8 x 8 tiles, then a 0.15 sharpen, as OpenCV
computes them), test-time augmentation, the threshold cascade, the tiled
grid with its Hann blend, and the train-mode draws.

Plain PyTorch and numpy only: nothing here imports the program under test.
Every function states the published or reference behaviour it restates.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

FP8_MAX = 448.0          # largest finite float8_e4m3fn


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded through float8 e4m3 with one scale for the tensor (its
    largest magnitude mapped to the format's largest), back in t's dtype."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` whose input and weight are rounded through fp8 when
    `precision` is "fp8" (the control), else computed as they are."""

    precision = "fp32"

    def forward(self, x):
        if self.precision == "fp8":
            return self._conv_forward(fp8_round(x), fp8_round(self.weight), self.bias)
        return super().forward(x)


def set_precision(model: nn.Module, precision: str) -> nn.Module:
    if precision not in ("fp32", "fp8"):
        raise ValueError(f"unknown precision {precision}")
    for m in model.modules():
        if isinstance(m, Conv2d):
            m.precision = precision
    return model


def plain_float32() -> None:
    """Full fp32 on the card: no TF32 in matmuls or cuDNN convs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# train-mode draws (dropout, stochastic depth)
# ---------------------------------------------------------------------------

def uniform_like(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Uniform draws of x's shape, filled in the order of the program's
    activation memory: channels-last on the card, NCHW on the CPU."""
    if x.is_cuda and x.ndim == 4:
        n, c, h, w = x.shape
        u = torch.empty((n, h, w, c), dtype=torch.float32, device=x.device)
        return u.uniform_(generator=generator).permute(0, 3, 1, 2)
    return torch.empty(x.shape, dtype=torch.float32, device=x.device).uniform_(
        generator=generator)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Element-wise dropout: keep where a uniform draw is below 1 - rate,
    scaled by 1 / (1 - rate)."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    return torch.where(uniform_like(x, generator) < keep, x / keep, torch.zeros_like(x))


def drop_path(y: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Stochastic depth per sample: the branch kept where floor(keep + U)
    is 1, scaled by 1 / keep."""
    keep = 1.0 - rate
    u = torch.rand((y.shape[0], 1, 1, 1), device=y.device, generator=generator)
    return y / keep * torch.floor(keep + u)


# ---------------------------------------------------------------------------
# preprocessing: cv2.cvtColor(RGB2LAB / LAB2RGB), CLAHE, filter2D
# ---------------------------------------------------------------------------

_RGB2XYZ = np.array([[0.412453, 0.357580, 0.180423],
                     [0.212671, 0.715160, 0.072169],
                     [0.019334, 0.119193, 0.950227]], np.float32)
_XYZ2RGB = np.array([[3.240479, -1.537150, -0.498535],
                     [-0.969256, 1.875991, 0.041556],
                     [0.055648, -0.204043, 1.057311]], np.float32)
_D65 = np.array([0.950456, 1.0, 1.088754], np.float32)


def _saturate_u8(x: np.ndarray) -> np.ndarray:
    """OpenCV's saturate_cast<uchar>: round half to even, clip to 0..255."""
    return np.clip(np.rint(x), 0, 255).astype(np.float32)


def rgb_to_lab(img: np.ndarray) -> np.ndarray:
    """[..., 3] uint8-domain RGB -> uint8-domain LAB (OpenCV's float formulas:
    sRGB gamma, D65 white, L scaled by 255 / 100, a and b offset by 128)."""
    c = img.astype(np.float32) / np.float32(255.0)
    lin = np.where(c <= 0.04045, c / np.float32(12.92),
                   ((c + np.float32(0.055)) / np.float32(1.055)) ** np.float32(2.4))
    xyz = [sum(lin[..., j] * _RGB2XYZ[k, j] for j in range(3)) for k in range(3)]
    x, y, z = (xyz[k] / _D65[k] for k in range(3))

    def f(t):
        return np.where(t > 0.008856, np.cbrt(np.maximum(t, 0)),
                        np.float32(7.787) * t + np.float32(16.0 / 116.0))

    L = np.where(y > 0.008856, np.float32(116.0) * np.cbrt(np.maximum(y, 0)) - 16.0,
                 np.float32(903.3) * y)
    a = 500.0 * (f(x) - f(y)) + 128.0
    b = 200.0 * (f(y) - f(z)) + 128.0
    return _saturate_u8(np.stack([L * np.float32(255.0 / 100.0), a, b], -1).astype(np.float32))


def lab_to_rgb(lab: np.ndarray) -> np.ndarray:
    """The inverse of `rgb_to_lab`, uint8-domain."""
    L = lab[..., 0] * np.float32(100.0 / 255.0)
    a = lab[..., 1] - np.float32(128.0)
    b = lab[..., 2] - np.float32(128.0)
    fy = (L + np.float32(16.0)) / np.float32(116.0)
    fx = fy + a / np.float32(500.0)
    fz = fy - b / np.float32(200.0)

    def finv(t):
        t3 = t ** 3
        return np.where(t3 > 0.008856, t3, (t - np.float32(16.0 / 116.0)) / np.float32(7.787))

    y = np.where(L > 903.3 * 0.008856, fy ** 3, L / np.float32(903.3))
    xyz = [finv(fx) * _D65[0], y * _D65[1], finv(fz) * _D65[2]]
    rgb = np.stack([sum(xyz[j] * _XYZ2RGB[k, j] for j in range(3)) for k in range(3)], -1)
    rgb = np.clip(rgb, 0.0, 1.0).astype(np.float32)
    srgb = np.where(rgb <= 0.0031308, rgb * np.float32(12.92),
                    np.float32(1.055) * rgb ** np.float32(1 / 2.4) - np.float32(0.055))
    return _saturate_u8(srgb * np.float32(255.0))


def clahe(channel: np.ndarray, clip_limit: float, grid: Tuple[int, int] = (8, 8)) -> np.ndarray:
    """OpenCV's CLAHE of one uint8-domain [H, W] channel whose sides divide
    the grid: per-tile histograms clipped at max(int(clip * area / 256), 1),
    the excess spread evenly and its remainder one count at a time from bin
    0 in steps of max(256 / remainder, 1); LUT = saturate(cdf * 255 / area);
    each pixel a bilinear mix of its four nearest tiles' LUTs."""
    h, w = channel.shape
    gy, gx = grid
    th, tw = h // gy, w // gx
    area = th * tw
    clip = max(int(clip_limit * area / 256), 1)
    v = channel.astype(np.int64)
    luts = np.zeros((gy, gx, 256), np.float32)
    for ty in range(gy):
        for tx in range(gx):
            hist = np.bincount(v[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw].ravel(),
                               minlength=256)
            excess = int(np.maximum(hist - clip, 0).sum())
            hist = np.minimum(hist, clip) + excess // 256
            residual = excess % 256
            if residual:
                step = max(256 // residual, 1)
                for i in range(0, 256, step):
                    if residual == 0:
                        break
                    hist[i] += 1
                    residual -= 1
            luts[ty, tx] = _saturate_u8(np.cumsum(hist) * np.float32(255.0 / area))
    tyf = np.arange(h, dtype=np.float32) * np.float32(1.0 / th) - np.float32(0.5)
    txf = np.arange(w, dtype=np.float32) * np.float32(1.0 / tw) - np.float32(0.5)
    ty1 = np.floor(tyf).astype(np.int64)
    tx1 = np.floor(txf).astype(np.int64)
    ya = (tyf - ty1)[:, None]
    xa = (txf - tx1)[None, :]
    y1, y2 = np.clip(ty1, 0, gy - 1)[:, None], np.clip(ty1 + 1, 0, gy - 1)[:, None]
    x1, x2 = np.clip(tx1, 0, gx - 1)[None, :], np.clip(tx1 + 1, 0, gx - 1)[None, :]
    res = ((luts[y1, x1, v] * (1 - xa) + luts[y1, x2, v] * xa) * (1 - ya)
           + (luts[y2, x1, v] * (1 - xa) + luts[y2, x2, v] * xa) * ya)
    return _saturate_u8(res)


def sharpen(img: np.ndarray, strength: float = 0.15) -> np.ndarray:
    """cv2.filter2D(img, -1, [[-1,-1,-1],[-1,9,-1],[-1,-1,-1]] * strength),
    BORDER_REFLECT_101, of [H, W, 3] uint8-domain values."""
    k = np.array([[-1, -1, -1], [-1, 9, -1], [-1, -1, -1]], np.float32) * np.float32(strength)
    h, w = img.shape[:2]
    p = np.pad(img, ((1, 1), (1, 1), (0, 0)), mode="reflect")
    out = np.zeros_like(img, dtype=np.float32)
    for u in range(3):
        for v in range(3):
            out += p[u:u + h, v:v + w] * k[u, v]
    return _saturate_u8(out)


def enhance(image01: np.ndarray) -> np.ndarray:
    """Inference preprocessing of one [H, W, 3] image in [0, 1]: LAB CLAHE
    (clip 2.0) on L, back to RGB, 0.15 sharpen; returns [H, W, 3] in [0, 1]."""
    lab = rgb_to_lab(image01.astype(np.float32) * np.float32(255.0))
    lab[..., 0] = clahe(lab[..., 0], 2.0)
    return sharpen(lab_to_rgb(lab)) / np.float32(255.0)


# ---------------------------------------------------------------------------
# test-time augmentation and the threshold cascade
# ---------------------------------------------------------------------------

def _resize(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Half-pixel bilinear resize of NCHW, no antialiasing."""
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False)


def probs_of(forward, x: torch.Tensor) -> torch.Tensor:
    """Softmax probabilities NCHW of a forward on NCHW images, the images
    reflect-padded at the bottom and right to a multiple of 32 and the
    result cropped back."""
    h, w = x.shape[-2:]
    ph, pw = -h % 32, -w % 32
    xp = F.pad(x, (0, pw, 0, ph), mode="reflect") if ph or pw else x
    return torch.softmax(forward(xp).float(), dim=1)[..., :h, :w]


def tta_probs(forward, x: torch.Tensor, tta: bool,
              scales: Sequence[float] = (0.75, 1.25)) -> torch.Tensor:
    """Probabilities of NCHW images: with `tta`, the mean of the identity,
    horizontal flip, vertical flip and the two rescaled views, each mapped
    back to the image's frame."""
    if not tta:
        return probs_of(forward, x)
    h, w = x.shape[-2:]
    views = [probs_of(forward, x),
             probs_of(forward, x.flip(3)).flip(3),
             probs_of(forward, x.flip(2)).flip(2)]
    for s in scales:
        sh, sw = int(h * s), int(w * s)
        views.append(_resize(probs_of(forward, _resize(x, (sh, sw))), (h, w)))
    return torch.stack(views).mean(0)


RATIO_FLAGS = ("live_over_half", "dead_over_015", "dead_over_025", "dead_over_04")


def cascade(probs: torch.Tensor, flags: Optional[Dict[str, bool]] = None
            ) -> Tuple[torch.Tensor, Dict[str, float]]:
    """The reference's semantic threshold cascade on [3, H, W] probabilities
    (background, live, dead) of one image.  Returns the mask [H, W] and the
    image's live and dead pixel ratios before the density rules.  `flags`
    overrides the density rules' four comparisons of those ratios."""
    bg, live, dead = probs[0], probs[1], probs[2]
    pred = probs.argmax(0)
    pred[(pred == 1) & ((live < 0.42) | (live <= bg * 1.15))] = 0
    pred[(pred == 2) & ((dead < 0.5) | (dead <= bg * 1.3) | (bg > 0.3)
                        | (live > dead * 0.9))] = 0
    reclaim_live = (pred == 0) & (live > 0.42) & (live > bg * 1.15) & (live > dead * 1.05)
    pred[reclaim_live] = 1
    pred[(pred == 0) & (dead > 0.5) & (dead > bg * 1.3) & (dead > live * 1.1)
         & (bg < 0.3) & ~reclaim_live] = 2
    to_dead = (pred == 1) & (dead > live * 1.15) & (dead > 0.45)
    pred[to_dead] = 2
    pred[(pred == 2) & (live > dead * 1.15) & (live > 0.42)] = 1
    pred[probs.amax(0) < 0.3] = 0

    n = pred.numel()
    ratios = {"live": (pred == 1).sum().item() / n, "dead": (pred == 2).sum().item() / n}
    f = {"live_over_half": ratios["live"] > 0.5, "dead_over_015": ratios["dead"] > 0.15,
         "dead_over_025": ratios["dead"] > 0.25, "dead_over_04": ratios["dead"] > 0.4}
    f.update(flags or {})
    if f["live_over_half"]:
        pred[(pred == 1) & ~((live > 0.5) & (live > bg * 1.3) & (bg < 0.3))] = 0
    if f["dead_over_015"]:
        if f["dead_over_04"]:
            thr, mult, bg_thr, guard = 0.65, 1.6, 0.2, live < dead * 0.7
        elif f["dead_over_025"]:
            thr, mult, bg_thr, guard = 0.6, 1.5, 0.25, live < dead * 0.8
        else:
            thr, mult, bg_thr, guard = 0.55, 1.4, 0.25, torch.ones_like(live, dtype=torch.bool)
        dead_high = (dead > thr) & (dead > bg * mult) & (bg < bg_thr) & guard
        pred[(pred == 2) & ~dead_high] = 0
    return pred, ratios


def admissible_masks(probs: torch.Tensor, margin: float) -> List[torch.Tensor]:
    """The cascade's mask of one image and, where the image's live or dead
    ratio lies within `margin` of a density rule's threshold, the masks with
    that rule's comparison turned the other way: any of them is a sound
    answer for probabilities that differ from these by rounding."""
    mask, r = cascade(probs)
    near = {"live_over_half": abs(r["live"] - 0.5) <= margin,
            "dead_over_015": abs(r["dead"] - 0.15) <= margin,
            "dead_over_025": abs(r["dead"] - 0.25) <= margin,
            "dead_over_04": abs(r["dead"] - 0.4) <= margin}
    base = {"live_over_half": r["live"] > 0.5, "dead_over_015": r["dead"] > 0.15,
            "dead_over_025": r["dead"] > 0.25, "dead_over_04": r["dead"] > 0.4}
    out = [mask]
    for name in RATIO_FLAGS:
        if near[name]:
            out.append(cascade(probs, {**base, name: not base[name]})[0])
    return out


def mismatch_share(mask: torch.Tensor, admissible: List[torch.Tensor]) -> float:
    """Share of pixels whose class is in none of the admissible masks."""
    ok = torch.zeros_like(admissible[0], dtype=torch.bool)
    for m in admissible:
        ok |= mask.to(m.device).long() == m.long()
    return 1.0 - ok.float().mean().item()


# ---------------------------------------------------------------------------
# tiled inference: the grid, reflect padding, the Hann blend
# ---------------------------------------------------------------------------

def tile_starts(size: int, tile: int, overlap: int) -> List[int]:
    """Window starts `tile - overlap` apart from 0, the last one at the edge."""
    if size <= tile:
        return [0]
    starts = list(range(0, size - tile + 1, tile - overlap))
    if starts[-1] != size - tile:
        starts.append(size - tile)
    return starts


def hann2d(tile: int, floor: float = 1e-3) -> np.ndarray:
    """Outer product of the periodic-centred Hann window 0.5 - 0.5 cos(2 pi
    (i + 0.5) / tile), floored at `floor`."""
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * (np.arange(tile) + 0.5) / tile)
    return np.maximum(np.outer(w, w), floor).astype(np.float32)


def tiled_probs(tile_fn, image: torch.Tensor, tile: int, overlap: int,
                chunk: int) -> torch.Tensor:
    """Probabilities [C, H, W] of one NCHW-less image [3, H, W]: windows of
    `tile` pixels (the image reflect-padded up to a tile where smaller), each
    window's probabilities from `tile_fn` ([n, 3, t, t] -> [n, C, t, t]) in
    chunks of `chunk`, blended by the Hann window and normalised by the
    summed weight."""
    _, h, w = image.shape
    ph, pw = max(h, tile), max(w, tile)
    if (ph, pw) != (h, w):
        rows = torch.from_numpy(np.pad(np.arange(h), (0, ph - h), mode="reflect"))
        cols = torch.from_numpy(np.pad(np.arange(w), (0, pw - w), mode="reflect"))
        image = image[:, rows.to(image.device)][:, :, cols.to(image.device)]
    corners = [(y, x) for y in tile_starts(ph, tile, overlap)
               for x in tile_starts(pw, tile, overlap)]
    window = torch.from_numpy(hann2d(tile)).to(image.device)
    acc = wsum = None
    for s in range(0, len(corners), chunk):
        part = corners[s:s + chunk]
        p = tile_fn(torch.stack([image[:, y:y + tile, x:x + tile] for y, x in part]))
        if acc is None:
            acc = torch.zeros((p.shape[1], ph, pw), dtype=torch.float32, device=image.device)
            wsum = torch.zeros((ph, pw), dtype=torch.float32, device=image.device)
        for (y, x), pi in zip(part, p):
            acc[:, y:y + tile, x:x + tile] += pi.float() * window
            wsum[y:y + tile, x:x + tile] += window
    return (acc / wsum.clamp_min(1e-8))[:, :h, :w]


def effnet_round_filters(c: int, width_mult: float, divisor: int = 8) -> int:
    """EfficientNet's channel rounding to a multiple of `divisor`."""
    c *= width_mult
    new_c = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * c:
        new_c += divisor
    return int(new_c)


def effnet_round_repeats(r: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * r))
