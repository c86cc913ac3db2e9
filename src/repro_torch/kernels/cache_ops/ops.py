"""Entry points of the cache hot-path ops (port of
``repro.kernels.cache_ops.ops``), dispatched by the device of the tensors:
a CUDA tensor runs the hand-written kernel or raises, a CPU tensor runs the
plain version.  There is no switch to force either route.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.cache_ops import kernel as _kernel
from repro_torch.kernels.cache_ops import ref as _ref
from repro_torch.kernels.cache_ops.ref import PlanImage

__all__ = [
    "PAD_RANK",
    "PlanImage",
    "arena_gather_encode_impl",
    "arena_gather_impl",
    "bucketize_impl",
    "compact_front_impl",
    "dedup_impl",
    "merge_candidates_impl",
    "plan_image_impl",
    "route_bucketize_impl",
    "route_image_impl",
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


def route_bucketize_impl(
    uniq: torch.Tensor, rank_owner: torch.Tensor, rank_local: torch.Tensor, rep_k: int,
    num_shards: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The router's route and ``[S, U]`` image of the dedup'd ranks:
    ``(owner, local, image)``, -1 on replicated and padding lanes (one
    launch of the bucketize kernel's route entry on CUDA tensors)."""
    return _kernel.route_bucketize(uniq.contiguous(), rank_owner, rank_local, rep_k, num_shards)


def route_image_impl(
    uniq: torch.Tensor, rank_owner: torch.Tensor, rank_local: torch.Tensor, rep_k: int,
    num_shards: int,
) -> torch.Tensor:
    """The router's ``[S, U]`` image of the dedup'd ranks, -1 on replicated
    and padding lanes (one launch of the bucketize kernel's route entry,
    the image alone, on CUDA tensors)."""
    return _kernel.route_image(uniq.contiguous(), rank_owner, rank_local, rep_k, num_shards)


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
    # replicated head lanes never enter the exchange
    return (uniq, pos,
            *route_bucketize_impl(uniq, rank_owner, rank_local, rep_k, num_shards))


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


def arena_gather_encode_impl(
    head: torch.Tensor,
    tail: torch.Tensor,
    sideband: Optional[torch.Tensor],
    slots: torch.Tensor,
    codec: str,
    host_codec: str,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Tiered-arena gather + decode of one fp32 leaf, encoded for a host
    tier of ``host_codec`` (fp16 / int8): ``(payload, sideband or None)``,
    in one launch of the gather-decode kernel's encode entry on CUDA
    tensors."""
    return _kernel.gather_decode_encode(head, tail, sideband, slots, codec, host_codec)
