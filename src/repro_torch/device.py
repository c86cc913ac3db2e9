"""Device resolution with no silent CPU fallback.

Every entry point of the port takes a ``device`` argument.  ``None`` means
the CUDA card; without one that raises instead of running on the CPU, so a
run that was meant for the card can never quietly measure the host.  Only an
explicit ``"cpu"`` runs on the CPU (the tests do this).
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Union

import torch

__all__ = ["DeviceLike", "deterministic", "resolve_device"]

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


@contextlib.contextmanager
def deterministic() -> Iterator[None]:
    """torch's deterministic algorithms (warnings only where none exists),
    for two runs on the card that must agree bit for bit: outside that
    mode ``index_add_``, the gather's backward, sums a row's duplicate
    lanes with atomics in no fixed order.  Uninitialised memory is left
    unfilled.  The caller's mode is restored on exit."""
    import torch.utils.deterministic as det

    mode = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    fill = det.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(mode, warn_only=warn)
        det.fill_uninitialized_memory = fill
