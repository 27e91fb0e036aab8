"""Device resolution for the port's entry points.

Entry points take ``device=None`` and resolve it here to ``cuda``.  There
is no silent fall back to the CPU: without a CUDA device the caller is
told to ask for the CPU explicitly, which is what the CPU tests do.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; anything else is taken as given.  Raises
    ``RuntimeError`` when CUDA is asked for (explicitly or by default)
    and no CUDA device is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
