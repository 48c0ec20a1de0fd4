"""Device resolution for the port's entry points.

Entry points run on the first CUDA device unless the caller names another
device; ``device="cpu"`` selects the plain PyTorch path.  There is no
silent fallback: asking for CUDA where there is none raises.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda:0``; raises when CUDA is asked for and absent."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            f"pass device='cpu' to run the plain PyTorch path")
    return dev
