"""Every hand-written kernel's launch count, read and reset in one place.

Each wrapper adds one to its count where it launches its kernel, and
nowhere else (its CPU route counts nothing).  The fused entries count on
their kernel's ``launches`` and on its ``fused_launches``; the flash
wrapper counts by route as well.  A script that checks which kernels a
path launched sets every count to 0 just before the path and reads the
counts just after; a spawned rank starts from 0 and returns its own.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

__all__ = ["counters", "launch_counts", "zero_launch_counts"]


def counters() -> Tuple[Tuple[str, Any, str], ...]:
    """``(name, wrapper, attribute)`` of every kernel wrapper's launch count."""
    from repro_torch.kernels.cache_ops import kernel
    from repro_torch.kernels.embedding_bag import kernel as eb_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.fm_interaction import kernel as fm_kernel

    return (("victim_threshold", kernel.victim_threshold, "launches"),
            ("gather_decode", kernel.gather_decode, "launches"),
            ("gather_decode_encode", kernel.gather_decode, "fused_launches"),
            ("bucketize", kernel.bucketize, "launches"),
            ("route_bucketize", kernel.bucketize, "fused_launches"),
            ("embedding_bag", eb_kernel.embedding_bag_multi, "launches"),
            ("fm_interaction", fm_kernel.fm_interaction, "launches"),
            ("flash_attention", fa_kernel.flash_attention, "launches"))


def launch_counts() -> Dict[str, int]:
    """Every count of :func:`counters` by name (``gather_decode`` and
    ``bucketize`` include their fused entries), and the flash kernel's by
    route as ``flash_<route>``."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel

    out = {name: int(getattr(fn, attr)) for name, fn, attr in counters()}
    out.update({f"flash_{r}": int(n) for r, n in fa_kernel.flash_attention.route_launches.items()})
    return out


def zero_launch_counts() -> None:
    """Every count of :func:`launch_counts` to 0."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel

    for _, fn, attr in counters():
        setattr(fn, attr, 0)
    routes = fa_kernel.flash_attention.route_launches
    routes.update(dict.fromkeys(routes, 0))
