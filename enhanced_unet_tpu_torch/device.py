"""Default-device rule of the PyTorch package.

Entry points take `device=None`, which means the CUDA card.  Without a card
they raise: the package never carries on silently on the CPU.  Callers that
want the CPU (the parity tests) ask for it with `device="cpu"`.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`None` -> `cuda` (raises when no card is present); else `device`."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device
