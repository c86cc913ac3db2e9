"""Entry points of the cache hot-path ops (port of
``repro.kernels.cache_ops.ops``), dispatched by the device of the tensors:
a CUDA tensor runs the hand-written kernel or raises, a CPU tensor runs the
plain version.  There is no switch to force either route.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.cache_ops import kernel as _kernel
from repro_torch.kernels.cache_ops import ref as _ref
from repro_torch.kernels.cache_ops.ref import PlanImage

__all__ = ["PlanImage", "arena_gather_impl", "plan_image_impl", "victim_topk_impl"]


def victim_topk_impl(key: torch.Tensor, kv: int) -> torch.Tensor:
    """Bounded top-K victim selection, bit-identical to
    ``argsort(key, descending=True, stable=True)[:kv]`` as int32."""
    t, n_gt = _kernel.victim_threshold(key.contiguous(), kv)
    return _ref.topk_select(key, t, n_gt, kv)


def plan_image_impl(rows: torch.Tensor, row_to_slot: torch.Tensor, k: int) -> PlanImage:
    return _ref.plan_image(rows, row_to_slot, k)


def arena_gather_impl(
    head: torch.Tensor,
    tail: torch.Tensor,
    sideband: Optional[torch.Tensor],
    slots: torch.Tensor,
    codec: str,
) -> torch.Tensor:
    """Tiered-arena gather + decode of one fp32 leaf: fp32 ``[K, D]`` rows
    of ``slots`` (fp16 / int8 tail codecs)."""
    return _kernel.gather_decode(head, tail, sideband, slots, codec)
