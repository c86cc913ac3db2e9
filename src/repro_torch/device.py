"""Device resolution with no silent CPU fallback.

Every entry point of the port takes a ``device`` argument.  ``None`` means
the CUDA card; without one that raises instead of running on the CPU, so a
run that was meant for the card can never quietly measure the host.  Only an
explicit ``"cpu"`` runs on the CPU (the tests do this).
"""
from __future__ import annotations

from typing import Union

import torch

__all__ = ["DeviceLike", "resolve_device"]

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device must exist; ``cpu`` only on request."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
