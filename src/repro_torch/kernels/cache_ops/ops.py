"""Entry points of the cache hot-path ops (port of
``repro.kernels.cache_ops.ops``), dispatched by the device of the tensors:
a CUDA tensor runs the hand-written kernel or raises, a CPU tensor runs the
plain version.  There is no switch to force either route.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.lanes import take_fill
from repro_torch.kernels.cache_ops import kernel as _kernel
from repro_torch.kernels.cache_ops import ref as _ref
from repro_torch.kernels.cache_ops.ref import PlanImage

__all__ = [
    "PAD_RANK",
    "PlanImage",
    "arena_gather_impl",
    "bucketize_impl",
    "compact_front_impl",
    "dedup_impl",
    "merge_candidates_impl",
    "plan_image_impl",
    "shard_bucketize",
    "victim_topk_impl",
]

PAD_RANK = 2**31 - 1  # the router's padding sentinel: sorts after every real rank


def victim_topk_impl(key: torch.Tensor, kv: int) -> torch.Tensor:
    """Bounded top-K victim selection, bit-identical to
    ``argsort(key, descending=True, stable=True)[:kv]`` as int32."""
    t, n_gt = _kernel.victim_threshold(key.contiguous(), kv)
    return _ref.topk_select(key, t, n_gt, kv)


def dedup_impl(rows: torch.Tensor, k: int, fill: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return _ref.dedup(rows, k, fill)


def compact_front_impl(mask: torch.Tensor, values: torch.Tensor, out_len: int) -> torch.Tensor:
    return _ref.compact_front(mask, values, out_len)


def merge_candidates_impl(now: torch.Tensor, n_now: torch.Tensor, fut: torch.Tensor, kv: int
                          ) -> torch.Tensor:
    return _ref.merge_candidates(now, n_now, fut, kv)


def bucketize_impl(owner: torch.Tensor, local: torch.Tensor, num_shards: int) -> torch.Tensor:
    """The ``[S, U]`` per-shard routing image (the bucketize kernel on CUDA
    tensors)."""
    return _kernel.bucketize(owner.contiguous(), local.contiguous(), num_shards)


def shard_bucketize(
    rank: torch.Tensor,
    rank_owner: torch.Tensor,
    rank_local: torch.Tensor,
    rep_k: int,
    num_shards: int,
    u: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The sharded router's front end in one call: dedup the ranks (-1
    padding) into ``u`` lanes, route them to (owner, local) (-1 for the
    ``rep_k`` replicated ranks and padding), and build the ``[S, u]``
    image.  Returns ``(uniq, pos, owner_u, local_u, rows_sh)``, bitwise the
    collection's ``_dedup`` / ``_route`` / ``_bucketize`` composition."""
    key = torch.where(rank >= 0, rank, PAD_RANK)
    uniq, _ = dedup_impl(key, u, PAD_RANK)
    uniq = uniq.to(torch.int32)
    pos = torch.clamp_max(torch.searchsorted(uniq, key), u - 1).to(torch.int32)
    ok = uniq >= rep_k  # replicated head lanes never enter the exchange
    safe = torch.where(ok, uniq, 0)
    owner_u = torch.where(ok, take_fill(rank_owner, safe, -1), -1)
    local_u = torch.where(ok, take_fill(rank_local, safe, -1), -1)
    return uniq, pos, owner_u, local_u, bucketize_impl(owner_u, local_u, num_shards)


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
