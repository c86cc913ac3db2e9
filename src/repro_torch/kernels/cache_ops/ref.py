"""Plain PyTorch versions of the cache hot-path ops (port of
``repro.kernels.cache_ops.ref``), bit-identical to the reference:

* ``victim_topk`` — the ``kv`` largest eviction keys in stable descending
  order via a 32-round bitwise threshold descent (``kernel.py`` holds the
  descent and its CUDA kernel) plus one ``kv``-sized sort.
* ``dedup`` — fixed-size ``unique`` plus the true distinct count from one
  sort.
* ``compact_front`` — masked values compacted to the front, as a cumsum
  scatter.
* ``merge_candidates`` — the lookahead plan's load list: the current
  misses, then the window's, as a lane select.
* ``plan_image`` — fused dedup -> residency probe -> miss compaction.
* ``arena_gather`` — decode-on-read gather over one tiered arena leaf.
* ``bucketize`` — the sharded router's ``[S, U]`` per-shard routing image
  (``kernel.bucketize_plain``, which the CUDA kernel is held against).
* ``route`` — the router's ranks -> (owning shard, local row)
  (``kernel.route_plain``: the route the fused route + image kernel is held
  against).

The reference's uint32 keys are carried here as int64 values (torch's
uint32 supports too few ops): ``ordered_u32(key) = key + 2**31``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from repro_torch.core.lanes import i32, scatter_drop, take_fill
from repro_torch.kernels.cache_ops.kernel import bucketize_plain as bucketize
from repro_torch.kernels.cache_ops.kernel import route_plain as route
from repro_torch.kernels.cache_ops.kernel import victim_threshold_plain

__all__ = [
    "PlanImage",
    "arena_gather",
    "bucketize",
    "compact_front",
    "dedup",
    "merge_candidates",
    "ordered_u32",
    "plan_image",
    "route",
    "topk_select",
    "victim_topk",
]

INT_MAX = 2**31 - 1
_SIGN = 2**31


def ordered_u32(key: torch.Tensor) -> torch.Tensor:
    """Order-preserving int32 -> uint32 transform, as int64 values."""
    return key.to(torch.int64) + _SIGN


def victim_topk(key: torch.Tensor, kv: int) -> torch.Tensor:
    """``argsort(key, descending, stable)[:kv]`` without a capacity-sized sort."""
    t, n_gt = victim_threshold_plain(key, kv)
    return topk_select(key, t, n_gt, kv)


def topk_select(
    key: torch.Tensor, t: torch.Tensor, n_gt: torch.Tensor, kv: int
) -> torch.Tensor:
    """Select + order, given the threshold ``t`` (int64, ordered domain) and
    the strictly-greater count ``n_gt``: lanes above ``t`` plus the first
    ``kv - n_gt`` ties, compacted index-ascending, then ONE ``kv``-sized
    stable descending sort.  Compared in the int32 key domain, where
    ``u > t`` iff ``key > t - 2**31``."""
    kv = int(kv)
    t_key = (t - _SIGN).to(torch.int32)
    eq = (key == t_key).to(torch.int64)
    eq_rank = torch.cumsum(eq, 0) - eq  # exclusive rank among ties
    sel = (key > t_key) | ((eq == 1) & (eq_rank < kv - n_gt))
    csel = torch.cumsum(sel.to(torch.int64), 0)  # inclusive; csel[-1] == kv
    want = torch.arange(1, kv + 1, dtype=torch.int64, device=key.device)
    slots = torch.searchsorted(csel, want)
    order = torch.argsort(key[slots], descending=True, stable=True)
    return i32(slots[order])


def dedup(rows: torch.Tensor, k: int, fill: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``unique(rows, size=k, fill_value=fill)`` (ascending, ``fill``-padded)
    plus the TRUE distinct count, excluding ``fill`` lanes."""
    k = int(k)
    srt = torch.sort(rows).values
    first = torch.ones_like(srt, dtype=torch.bool)
    first[1:] = srt[1:] != srt[:-1]
    first &= srt != fill
    n_distinct = i32(first.sum())
    pos = torch.cumsum(first.to(torch.int32), 0) - 1
    empty = torch.full((k,), fill, dtype=rows.dtype, device=rows.device)
    return scatter_drop(empty, pos, srt, first), n_distinct


def compact_front(mask: torch.Tensor, values: torch.Tensor, out_len: int) -> torch.Tensor:
    """Masked ``values`` compacted to the front in order; -1 past the count."""
    pos = torch.cumsum(mask.to(torch.int32), 0) - 1
    empty = torch.full((int(out_len),), -1, dtype=values.dtype, device=values.device)
    return scatter_drop(empty, pos, values, mask)


def merge_candidates(now: torch.Tensor, n_now: torch.Tensor, fut: torch.Tensor, kv: int
                     ) -> torch.Tensor:
    """Lane ``j`` of the merged load list: ``now[j]`` while ``j < n_now``,
    then ``fut[j - n_now]`` (indices clamped into each run; the caller's
    ``active`` mask hides the lanes past both runs)."""
    j = torch.arange(int(kv), dtype=torch.int64, device=now.device)
    now_v = now[torch.clamp(j, 0, now.shape[0] - 1)]
    fut_v = fut[torch.clamp(j - n_now, 0, fut.shape[0] - 1)]
    return torch.where(j < n_now, now_v, fut_v)


@dataclasses.dataclass
class PlanImage:
    """Fused dedup -> residency-probe output (one sort, no lane argsorts)."""

    uniq: torch.Tensor  # int32 [k] ascending distinct rows, -1 padded
    uniq_sorted: torch.Tensor  # int32 [k] same, sentinel-padded
    uniq_valid: torch.Tensor  # bool [k]
    uniq_slots: torch.Tensor  # int32 [k] resident slot per unique (-1 miss)
    miss: torch.Tensor  # bool [k] valid + unresident
    miss_rows: torch.Tensor  # int32 [k] miss rows compacted to the front (-1)
    n_miss: torch.Tensor  # int32 []
    n_distinct: torch.Tensor  # int32 [] TRUE distinct count (overflow guard)


def plan_image(rows: torch.Tensor, row_to_slot: torch.Tensor, k: int) -> PlanImage:
    """Dedup ``rows`` (padded with int32 max) into ``k`` lanes, probe
    residency through ``row_to_slot``, compact the misses to the front."""
    uniq_sorted, n_distinct = dedup(rows, k, INT_MAX)
    uniq_valid = uniq_sorted != INT_MAX
    uniq = torch.where(uniq_valid, uniq_sorted, -1)
    uniq_slots = take_fill(row_to_slot, torch.where(uniq_valid, uniq, 0), -1)
    miss = (uniq_slots < 0) & uniq_valid
    return PlanImage(
        uniq=uniq,
        uniq_sorted=uniq_sorted,
        uniq_valid=uniq_valid,
        uniq_slots=uniq_slots,
        miss=miss,
        miss_rows=compact_front(miss, uniq, k),
        n_miss=i32(miss.sum()),
        n_distinct=n_distinct,
    )


def arena_gather(
    head: torch.Tensor,
    tail: torch.Tensor,
    sideband: Optional[torch.Tensor],
    slots: torch.Tensor,
    decode: Callable,
    out_dtype,
) -> torch.Tensor:
    """Decode-on-read gather over one tiered leaf: head lanes as stored,
    tail lanes ``decode(payload, sideband, out_dtype)``, negative / OOB
    lanes zero rows (their zero payload decodes to zero)."""
    h = head.shape[0]
    in_tail = slots >= h
    head_rows = take_fill(head, torch.where((slots >= 0) & ~in_tail, slots, h), 0)
    safe_t = torch.where(in_tail, slots - h, tail.shape[0])
    payload = take_fill(tail, safe_t, 0)
    side = None if sideband is None else take_fill(sideband, safe_t, 0)
    tail_rows = decode(payload, side, out_dtype)
    mask = in_tail.reshape(in_tail.shape + (1,) * (head_rows.dim() - in_tail.dim()))
    return torch.where(mask, tail_rows, head_rows)
