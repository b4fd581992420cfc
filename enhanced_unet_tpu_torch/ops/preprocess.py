"""Image enhancement, ported from `enhanced_unet_tpu/ops/preprocess.py`:
the inference-time `eval_preprocess` (LAB CLAHE on the L channel, clip 2.0,
8x8 tiles, then a 0.15 sharpen) and the train-time, GT-conditioned
`cell_specific_preprocess` with the colour, edge and blur helpers it and
the augmentation need.

Functions take float32 tensors holding uint8-domain values (0..255), as
[..., H, W, 3] images or [..., H, W] channels (any leading batch dims), and
reproduce OpenCV's quantisation at every stage boundary: `torch.round`
rounds half to even like `jnp.rint`.  Constants enter as Python scalars
holding their fp32 values, never as tensors copied to the device: such a
copy from pageable memory waits for the device's queue, which would stall
the host behind the train step it should run ahead of.  Torch has no `cbrt`, so the LAB
conversion takes `pow(t, 1/3)`; its last-ulp differences can flip a
rounding, hence the +/-1 grey-level agreement with the JAX package.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
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
_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))
_SOBEL_Y = ((-1.0, -2.0, -1.0), (0.0, 0.0, 0.0), (1.0, 2.0, 1.0))
_LAPLACIAN = ((0.0, 1.0, 0.0), (1.0, -4.0, 1.0), (0.0, 1.0, 0.0))


def _u8_round(x: torch.Tensor) -> torch.Tensor:
    """cv2 saturate_cast<uchar>: clip + round half to even."""
    return torch.clamp(torch.round(x), 0.0, 255.0)


def _u8_trunc(x: torch.Tensor) -> torch.Tensor:
    """np.clip(x, 0, 255).astype(np.uint8): clip + truncate toward zero."""
    return torch.floor(torch.clamp(x, 0.0, 255.0))


def _scalars(values):
    """A constant's fp32 values as Python floats (nested as given)."""
    return np.asarray(values, np.float32).tolist()


def _mix(c: torch.Tensor, matrix):
    """[..., 3] @ matrix^T, written out per channel (exact fp32 on any
    device): the three output channels."""
    m = _scalars(matrix)
    return [c[..., 0] * m[k][0] + c[..., 1] * m[k][1] + c[..., 2] * m[k][2]
            for k in range(3)]


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
    x, y, z = (t / w for t, w in zip(_mix(c, _XYZ_FROM_RGB), _scalars(_WHITE)))

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
    xyz = torch.stack([t * w for t, w in zip((finv(fx), y, finv(fz)), _scalars(_WHITE))],
                      dim=-1)
    rgb = torch.stack(_mix(xyz, _RGB_FROM_XYZ), dim=-1)
    return _u8_round(_linear_to_srgb(torch.clamp(rgb, 0.0, 1.0)) * 255.0)


def rgb_to_gray_u8(img: torch.Tensor) -> torch.Tensor:
    """cv2 RGB2GRAY fixed point: (R*4899 + G*9617 + B*1868 + 8192) >> 14
    (exact in fp32: the sum stays below 2^24)."""
    s = img[..., 0] * 4899.0 + img[..., 1] * 9617.0 + img[..., 2] * 1868.0
    return torch.floor((s + 8192.0) / 16384.0)


def rgb_to_hsv_u8(img: torch.Tensor) -> torch.Tensor:
    """cv2 RGB2HSV for uint8: H in 0..180, S and V in 0..255."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    diff = v - mn
    s = torch.where(v > 0, _u8_round(255.0 * diff / torch.clamp(v, min=1e-12)),
                    torch.zeros_like(v))
    safe = torch.clamp(diff, min=1e-12)
    h = torch.where(v == r, 60.0 * (g - b) / safe,
                    torch.where(v == g, 120.0 + 60.0 * (b - r) / safe,
                                240.0 + 60.0 * (r - g) / safe))
    h = torch.where(diff == 0, torch.zeros_like(h), h)
    h = torch.where(h < 0, h + 360.0, h)
    return torch.stack([_u8_round(h / 2.0), s, v], dim=-1)


def hsv_to_rgb_u8(hsv: torch.Tensor) -> torch.Tensor:
    """cv2 HSV2RGB for uint8 (H in 0..180).  The sector index uses Python's
    sign rule for `%` (`torch.remainder`), as `jnp.mod` does."""
    h = hsv[..., 0] * 2.0
    s = hsv[..., 1] / 255.0
    v = hsv[..., 2]
    hh = torch.remainder(h / 60.0, 6.0)
    i = torch.floor(hh)
    f = hh - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.to(torch.int64)

    def select(c0, c1, c2, c3, c4, default):
        out = default
        for k, c in reversed(list(enumerate((c0, c1, c2, c3, c4)))):
            out = torch.where(i == k, c, out)
        return out

    r = select(v, q, p, p, t, v)
    g = select(t, v, v, q, p, p)
    b = select(p, p, t, v, v, q)
    return _u8_round(torch.stack([r, g, b], dim=-1))


def clahe_dynamic(channel: torch.Tensor, clip: Union[int, torch.Tensor],
                  grid: Tuple[int, int] = (8, 8)) -> torch.Tensor:
    """OpenCV CLAHE of [..., H, W] uint8-domain channels with the integer
    clip threshold `clip` (= max(int(clip_limit * tile_area / 256), 1)):
    one `int` for every channel, or a tensor with one threshold per
    channel (shape `[...]`, the leading dims; the random-CLAHE stage of the
    augmentation draws one per sample).

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

    if isinstance(clip, torch.Tensor):
        clip = clip.to(device=dev, dtype=torch.int64).reshape(b, 1, 1).expand(
            b, gy * gx, 1).reshape(b * gy * gx, 1)
    excess = torch.clamp(hist - clip, min=0).sum(dim=1, keepdim=True)
    hist = (torch.minimum(hist, clip) if isinstance(clip, torch.Tensor)
            else torch.clamp(hist, max=clip)) + excess // 256
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

    if th % 2 == 0 and tw % 2 == 0:
        # the JAX package's half-tile path weighs with the product of the
        # two weights, its general path one weight after the other: the
        # same rounding here
        out = (lookup(ty1c, tx1c) * ((1 - xa) * (1 - ya))
               + lookup(ty1c, tx2c) * (xa * (1 - ya))
               + lookup(ty2c, tx1c) * ((1 - xa) * ya)
               + lookup(ty2c, tx2c) * (xa * ya))
    else:
        out = (lookup(ty1c, tx1c) * (1 - xa) * (1 - ya)
               + lookup(ty1c, tx2c) * xa * (1 - ya)
               + lookup(ty2c, tx1c) * (1 - xa) * ya
               + lookup(ty2c, tx2c) * xa * ya)
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


def _conv2d_same(x: torch.Tensor, k) -> torch.Tensor:
    """3x3 correlation of [..., H, W, C] with reflect-101 borders, as nine
    shifted multiply-adds in fp32.  `k` is one constant kernel (3 x 3
    floats), or a [N, 3, 3] tensor with one kernel per image (N the
    product of the leading dims)."""
    lead = x.shape[:-3]
    h, w, c = x.shape[-3:]
    xc = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    xp = F.pad(xc, (1, 1, 1, 1), mode="reflect")
    if isinstance(k, torch.Tensor):
        k = k.reshape(-1, 3, 3)
        taps = [[k[:, u, v].reshape(-1, 1, 1, 1) for v in range(3)] for u in range(3)]
    else:
        taps = _scalars(k)
    y = None
    for u in range(3):
        for v in range(3):
            t = xp[:, :, u:u + h, v:v + w] * taps[u][v]
            y = t if y is None else y + t
    return y.permute(0, 2, 3, 1).reshape(*lead, h, w, c)


def _conv2d_same_2d(x: torch.Tensor, k) -> torch.Tensor:
    """`_conv2d_same` of [..., H, W] channels."""
    return _conv2d_same(x[..., None], k)[..., 0]


def sharpen_filter(img: torch.Tensor, strength: float = 0.15) -> torch.Tensor:
    """cv2.filter2D with the 3x3 sharpen kernel * strength."""
    return _u8_round(_conv2d_same(img, np.float32(_SHARPEN) * np.float32(strength)))


def edge_channel(gray: torch.Tensor) -> torch.Tensor:
    """Sobel magnitude + Laplacian edge feature of [..., H, W] grey
    channels: each normalised by its own image's maximum to 0..255
    (truncated), blended 0.7 / 0.3 (truncated)."""
    sx = _conv2d_same_2d(gray, _SOBEL_X)
    sy = _conv2d_same_2d(gray, _SOBEL_Y)
    mag = torch.sqrt(sx ** 2 + sy ** 2)
    edges = _u8_trunc(mag / (mag.amax(dim=(-2, -1), keepdim=True) + 1e-6) * 255.0)
    lap = torch.abs(_conv2d_same_2d(gray, _LAPLACIAN))
    lap_n = _u8_trunc(lap / (lap.amax(dim=(-2, -1), keepdim=True) + 1e-6) * 255.0)
    return _u8_trunc(edges * 0.7 + lap_n * 0.3)


def gaussian_blur_3x3(img: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """cv2.GaussianBlur(ksize=(3, 3), sigma) of uint8-domain [..., H, W, C]
    (the kernel made in fp32 on the host, the same on every device)."""
    x = torch.exp(-0.5 * (torch.arange(-1, 2, dtype=torch.float32) / sigma) ** 2)
    k1 = x / x.sum()
    return _u8_round(_conv2d_same(img, torch.outer(k1, k1).numpy()))


def unsharp_mask(img: torch.Tensor) -> torch.Tensor:
    """cv2.addWeighted(img, 1.3, GaussianBlur(img, 3x3, 1.0), -0.3, 0)."""
    return _u8_round(img * 1.3 + gaussian_blur_3x3(img) * (-0.3))


def cell_specific_preprocess(image: torch.Tensor, live_mask: torch.Tensor,
                             dead_mask: torch.Tensor) -> torch.Tensor:
    """Train-time feature engineering of uint8-domain [..., H, W, 3] images
    with their [..., H, W] {0, 1} live and dead masks (the unions of each
    class's ground-truth instances): LAB CLAHE (clip 2.5), live regions
    brightened x1.1, dead regions replaced by a CLAHE (clip 3.0) of the
    grey image, a 0.9 / 0.1 blend with the edge channel of the original
    image, a 0.85 / 0.15 blend with the original, and an unsharp mask.  The
    GT-conditioned stages are a train-time-only transform, as in the
    reference."""
    image = image.to(torch.float32)
    image_clahe = clahe_on_l_channel(image, clip_limit=2.5)
    edges_rgb = edge_channel(rgb_to_gray_u8(image))[..., None]
    live3 = live_mask[..., None] > 0
    image_clahe = torch.where(live3, _u8_trunc(image_clahe * 1.1), image_clahe)
    dead3 = dead_mask[..., None] > 0
    dead_clahe = clahe_u8(rgb_to_gray_u8(image_clahe), clip_limit=3.0)[..., None]
    image_clahe = torch.where(dead3, dead_clahe, image_clahe)
    image_with_edges = _u8_trunc(image_clahe * 0.9 + edges_rgb * 0.1)
    image_final = _u8_trunc(image_with_edges * 0.85 + image * 0.15)
    return _u8_trunc(unsharp_mask(image_final))


def eval_preprocess(image: torch.Tensor) -> torch.Tensor:
    """LAB CLAHE clip 2.0 + 0.15 sharpen of uint8-domain [..., H, W, 3]."""
    image = clahe_on_l_channel(image.to(torch.float32), clip_limit=2.0)
    return sharpen_filter(image, strength=0.15)
