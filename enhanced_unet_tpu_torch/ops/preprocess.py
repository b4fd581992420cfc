"""Inference-time image enhancement, ported from
`enhanced_unet_tpu/ops/preprocess.py` (`eval_preprocess` and what it
needs): LAB CLAHE on the L channel (clip 2.0, 8x8 tiles) then a 0.15 sharpen.

Functions take float32 tensors holding uint8-domain values (0..255), as
[..., H, W, 3] images or [..., H, W] channels (any leading batch dims), and
reproduce OpenCV's quantisation at every stage boundary: `torch.round`
rounds half to even like `jnp.rint`.  Torch has no `cbrt`, so the LAB
conversion takes `pow(t, 1/3)`; its last-ulp differences can flip a
rounding, hence the +/-1 grey-level agreement with the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

_XYZ_FROM_RGB = (
    (0.412453, 0.357580, 0.180423),
    (0.212671, 0.715160, 0.072169),
    (0.019334, 0.119193, 0.950227),
)
_RGB_FROM_XYZ = (
    (3.240479, -1.537150, -0.498535),
    (-0.969256, 1.875991, 0.041556),
    (0.055648, -0.204043, 1.057311),
)
_WHITE = (0.950456, 1.0, 1.088754)
_SHARPEN = ((-1.0, -1.0, -1.0), (-1.0, 9.0, -1.0), (-1.0, -1.0, -1.0))


def _u8_round(x: torch.Tensor) -> torch.Tensor:
    """cv2 saturate_cast<uchar>: clip + round half to even."""
    return torch.clamp(torch.round(x), 0.0, 255.0)


def _f32(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=like.device)


def _mix(c: torch.Tensor, matrix) -> torch.Tensor:
    """[..., 3] @ matrix^T, written out per channel (exact fp32 on any
    device)."""
    m = _f32(matrix, c)
    return torch.stack([c[..., 0] * m[k, 0] + c[..., 1] * m[k, 1]
                        + c[..., 2] * m[k, 2] for k in range(3)], dim=-1)


def _srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    return torch.where(c <= 0.0031308, c * 12.92, 1.055 * c ** (1 / 2.4) - 0.055)


def _cbrt_pos(t: torch.Tensor) -> torch.Tensor:
    """Cube root of the positive entries (the only ones the callers keep)."""
    return torch.pow(torch.clamp(t, min=0.0), 1.0 / 3.0)


def rgb_to_lab_u8(img: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(COLOR_RGB2LAB) for uint8-domain float input [..., 3]."""
    c = _srgb_to_linear(img / 255.0)
    xyz = _mix(c, _XYZ_FROM_RGB) / _f32(_WHITE, img)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]

    def f(t):
        return torch.where(t > 0.008856, _cbrt_pos(t), 7.787 * t + 16.0 / 116.0)

    L = torch.where(y > 0.008856, 116.0 * _cbrt_pos(y) - 16.0, 903.3 * y)
    a = 500.0 * (f(x) - f(y)) + 128.0
    b = 200.0 * (f(y) - f(z)) + 128.0
    return _u8_round(torch.stack([L * 255.0 / 100.0, a, b], dim=-1))


def lab_to_rgb_u8(lab: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(COLOR_LAB2RGB), the inverse of `rgb_to_lab_u8`."""
    L = lab[..., 0] * (100.0 / 255.0)
    a = lab[..., 1] - 128.0
    b = lab[..., 2] - 128.0
    fy = (L + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0

    def finv(f):
        return torch.where(f ** 3 > 0.008856, f ** 3, (f - 16.0 / 116.0) / 7.787)

    y = torch.where(L > 903.3 * 0.008856, fy ** 3, L / 903.3)
    xyz = torch.stack([finv(fx), y, finv(fz)], dim=-1) * _f32(_WHITE, lab)
    rgb = _linear_to_srgb(torch.clamp(_mix(xyz, _RGB_FROM_XYZ), 0.0, 1.0))
    return _u8_round(rgb * 255.0)


def clahe_dynamic(channel: torch.Tensor, clip: int,
                  grid: Tuple[int, int] = (8, 8)) -> torch.Tensor:
    """OpenCV CLAHE of [..., H, W] uint8-domain channels with the integer
    clip threshold `clip` (= max(int(clip_limit * tile_area / 256), 1)).

    Exact per-tile histograms (`scatter_add`); clipped excess spread evenly
    plus OpenCV's stepped residual pass; LUT = rint(cdf * 255 / tile_area);
    output = rint of the bilinear mix of the four neighbouring tiles' LUTs
    at tile coordinates y / tile_h - 0.5."""
    *lead, h, w = channel.shape
    gy, gx = grid
    if h % gy or w % gx:
        raise ValueError(f"CLAHE input {h}x{w} must divide grid {grid}")
    th, tw = h // gy, w // gx
    area = th * tw
    dev = channel.device
    v = torch.clamp(channel, 0, 255).to(torch.int64).reshape(-1, h, w)
    b = v.shape[0]
    tiles = v.reshape(b, gy, th, gx, tw).permute(0, 1, 3, 2, 4).reshape(
        b * gy * gx, area)
    hist = torch.zeros((b * gy * gx, 256), dtype=torch.int64, device=dev)
    hist.scatter_add_(1, tiles, torch.ones_like(tiles))

    excess = torch.clamp(hist - clip, min=0).sum(dim=1, keepdim=True)
    hist = torch.clamp(hist, max=clip) + excess // 256
    residual = excess % 256
    step = torch.clamp(256 // torch.clamp(residual, min=1), min=1)
    idx = torch.arange(256, device=dev)[None]
    bump = (residual > 0) & (idx % step == 0) & (idx // step < residual)
    hist = hist + bump.to(torch.int64)
    luts = torch.round(torch.cumsum(hist, dim=1).to(torch.float32)
                       * (255.0 / area)).reshape(b, gy, gx, 256)

    tyf = torch.arange(h, dtype=torch.float32, device=dev) / th - 0.5
    txf = torch.arange(w, dtype=torch.float32, device=dev) / tw - 0.5
    ty1 = torch.floor(tyf).to(torch.int64)
    tx1 = torch.floor(txf).to(torch.int64)
    ya = (tyf - ty1.to(torch.float32))[:, None]
    xa = (txf - tx1.to(torch.float32))[None, :]
    ty1c, ty2c = torch.clamp(ty1, 0, gy - 1), torch.clamp(ty1 + 1, 0, gy - 1)
    tx1c, tx2c = torch.clamp(tx1, 0, gx - 1), torch.clamp(tx1 + 1, 0, gx - 1)

    flat = luts.reshape(b, gy * gx * 256)

    def lookup(ty, tx):
        i = (ty[:, None] * gx + tx[None, :]) * 256      # [h, w]
        return torch.gather(flat, 1, (i[None] + v).reshape(b, h * w)).reshape(b, h, w)

    out = (lookup(ty1c, tx1c) * ((1 - xa) * (1 - ya))
           + lookup(ty1c, tx2c) * (xa * (1 - ya))
           + lookup(ty2c, tx1c) * ((1 - xa) * ya)
           + lookup(ty2c, tx2c) * (xa * ya))
    return _u8_round(out).reshape(*lead, h, w)


def clahe_u8(channel: torch.Tensor, clip_limit: float = 2.5,
             grid: Tuple[int, int] = (8, 8)) -> torch.Tensor:
    """cv2.createCLAHE(clipLimit, tileGridSize).apply on [..., H, W]."""
    h, w = channel.shape[-2:]
    area = (h // grid[0]) * (w // grid[1])
    return clahe_dynamic(channel, max(int(clip_limit * area / 256), 1), grid)


def clahe_on_l_channel(img: torch.Tensor, clip_limit: float,
                       grid: Tuple[int, int] = (8, 8)) -> torch.Tensor:
    """LAB-space CLAHE on the L channel of [..., H, W, 3]."""
    lab = rgb_to_lab_u8(img)
    l_enh = clahe_u8(lab[..., 0], clip_limit=clip_limit, grid=grid)
    return lab_to_rgb_u8(torch.cat([l_enh[..., None], lab[..., 1:]], dim=-1))


def _conv2d_same(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """3x3 correlation of [..., H, W, C] with reflect-101 borders, as nine
    shifted multiply-adds in fp32."""
    lead = x.shape[:-3]
    h, w, c = x.shape[-3:]
    xc = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    xp = F.pad(xc, (1, 1, 1, 1), mode="reflect")
    y = None
    for u in range(3):
        for v in range(3):
            t = xp[:, :, u:u + h, v:v + w] * k[u, v]
            y = t if y is None else y + t
    return y.permute(0, 2, 3, 1).reshape(*lead, h, w, c)


def sharpen_filter(img: torch.Tensor, strength: float = 0.15) -> torch.Tensor:
    """cv2.filter2D with the 3x3 sharpen kernel * strength."""
    return _u8_round(_conv2d_same(img, _f32(_SHARPEN, img) * strength))


def eval_preprocess(image: torch.Tensor) -> torch.Tensor:
    """LAB CLAHE clip 2.0 + 0.15 sharpen of uint8-domain [..., H, W, 3]."""
    image = clahe_on_l_channel(image.to(torch.float32), clip_limit=2.0)
    return sharpen_filter(image, strength=0.15)
