"""Seeded bright-field micrographs of cell cultures, made on the device.

A grey, unevenly lit background with grain; cells on a jittered grid
(one grid site in `spacing` pixels, occupied with probability
`occupancy`), each a disk of radius `radius` pixels: live cells (class 1)
mid-grey with a bright halo, dead cells (class 2) dark and mottled.  Values
are 8-bit levels scaled to [0, 1], as a camera's frames are.
"""

from __future__ import annotations

from typing import Tuple

import torch

from portbench.weights import generator


def micrographs(n: int, height: int, width: int, seed: int, device,
                spacing: int = 40, occupancy: float = 0.7, radius: Tuple[float, float] = (6, 14),
                dead_share: float = 0.3, stream: str = "inputs"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(images [n, H, W, 3] float32 in [0, 1], masks [n, H, W] int64 with
    0 background, 1 live, 2 dead), all drawn from `seed`'s `stream`."""
    g = generator(seed, stream, device)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    gy, gx = -(-height // spacing) + 1, -(-width // spacing) + 1
    centre_y = (torch.arange(gy, device=device)[:, None] + rand(n, gy, gx)) * spacing
    centre_x = (torch.arange(gx, device=device)[None, :] + rand(n, gy, gx)) * spacing
    r = radius[0] + (radius[1] - radius[0]) * rand(n, gy, gx)
    present = rand(n, gy, gx) < occupancy
    dead = rand(n, gy, gx) < dead_share

    yy = torch.arange(height, device=device, dtype=torch.float32)[:, None].expand(height, width)
    xx = torch.arange(width, device=device, dtype=torch.float32)[None, :].expand(height, width)
    cy, cx = (yy // spacing).long(), (xx // spacing).long()
    best = torch.full((n, height, width), float("inf"), device=device)
    cls = torch.zeros((n, height, width), dtype=torch.long, device=device)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            iy, ix = (cy + dy).clamp(0, gy - 1), (cx + dx).clamp(0, gx - 1)
            d = torch.sqrt((yy - centre_y[:, iy, ix]) ** 2 + (xx - centre_x[:, iy, ix]) ** 2)
            d = torch.where(present[:, iy, ix], d / r[:, iy, ix], torch.inf)
            closer = d < best
            best = torch.where(closer, d, best)
            cls = torch.where(closer, 1 + dead[:, iy, ix].long(), cls)

    light = 0.72 + 0.06 * torch.sin(yy / height * 3.1 + rand(n, 1, 1) * 6.3) \
        * torch.cos(xx / width * 2.3 + rand(n, 1, 1) * 6.3)
    img = light + 0.02 * torch.randn((n, height, width), generator=g, device=device)
    inside = best <= 1.0
    halo = (best > 0.85) & (best <= 1.2) & (cls == 1)
    live_v = 0.55 + 0.05 * torch.randn((n, height, width), generator=g, device=device)
    dead_v = 0.33 + 0.08 * rand(n, height, width)
    img = torch.where(halo, img + 0.12, img)
    img = torch.where(inside & (cls == 1) & ~halo, live_v, img)
    img = torch.where(inside & (cls == 2), dead_v, img)
    mask = torch.where(inside, cls, torch.zeros_like(cls))
    tint = torch.tensor([1.0, 0.97, 0.93], device=device)
    rgb = torch.round((img[..., None] * tint).clamp(0, 1) * 255.0) / 255.0
    return rgb.float().contiguous(), mask
