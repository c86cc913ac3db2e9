"""The dynamic module (paper §4.3, Algorithm 1), port of ``repro.core.cache``.

State layout (device tensors, as in the reference):

  cached_rows   the cached-weight arena: a dict of [capacity, ...] leaves
                (fp32), or a frequency-tiered ``ArenaStore`` (fp32 head +
                fp16 / int8 tail) when ``arena_precision`` is fp16 / int8
  slot_to_row   int32 [capacity]   freq-ranked row held by each slot (-1 = empty)
  row_to_slot   int32 [vocab]      inverse map (-1 = not cached)
  last_used / use_count  int32 [capacity]  only read by non-paper policies
  counters      int32 scalars that wrap like the reference's

``plan_prepare`` is functional: it returns a :class:`CachePlan` and leaves
the state untouched.  ``apply_plan`` moves rows through the transmitter,
which updates the arena (and, with writeback, the host table) IN PLACE: the
state passed to it must not be used again.

Lookahead: ``plan_prepare(future_rows=)`` merges a window of future
batches' rows into the admission decision (they load now and are pinned
against eviction), as the pipelined trainer needs.  ``chunk_rows`` stages
the host side of every move in whole chunks (bitwise the row path).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.analysis.contracts import INT_COUNTERS, contract
from repro_torch.core import freq as freq_lib
from repro_torch.core import transmitter
from repro_torch.core.lanes import i32, scatter_drop, take_fill
from repro_torch.core.policies import Policy, eviction_key
from repro_torch.kernels.cache_ops import ops as cache_ops
from repro_torch.store.arena import ArenaStore

__all__ = [
    "CacheConfig",
    "CacheState",
    "CachePlan",
    "init_cache",
    "plan_prepare",
    "apply_plan",
    "prepare",
    "lookup_slots",
    "flush",
    "warmup",
]

INT_MAX = 2**31 - 1
_BIG = INT_MAX // 2


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    vocab: int  # total rows of the (concatenated, freq-ordered) table
    capacity: int  # cached rows (= cache_ratio * vocab)
    ids_per_step: int  # size of the flattened id vector per prepare()
    buffer_rows: int = 65536  # transmitter staging-block rows per round
    policy: Policy = Policy.FREQ_LFU
    writeback: bool = True  # False for inference (cache rows stay clean)
    protect_via_inverse: bool = True  # O(K) scatter instead of the paper's isin
    max_unique_per_step: int = 0  # 0 = ids_per_step; overflow is counted
    arena_precision: str = "fp32"  # fp16/int8: a frequency-tiered ArenaStore
    arena_head_ratio: float = 0.25  # fraction of capacity kept fp32 when tiered
    freq_half_life: int = 1024  # plan calls for a tracker count to halve
    use_pallas_plan: bool = False  # bounded top-K + fused dedup route
    chunk_rows: int = 0  # host-side staging granularity (0 = rows); bitwise either way

    def __post_init__(self):
        if self.capacity < self.unique_size:
            raise ValueError(
                f"cache capacity {self.capacity} must hold one batch's unique rows "
                f"(<= {self.unique_size})"
            )
        if self.arena_precision not in ("fp32", "fp16", "int8"):
            raise ValueError(
                f"arena_precision must be fp32/fp16/int8 at the cache level (auto resolves "
                f"above, in EmbeddingCollection.init), got {self.arena_precision!r}"
            )
        if not 0.0 < self.arena_head_ratio <= 1.0:
            raise ValueError(f"arena_head_ratio must be in (0, 1], got {self.arena_head_ratio}")
        if self.chunk_rows < 0:
            raise ValueError(f"chunk_rows must be >= 0, got {self.chunk_rows}")

    @property
    def unique_size(self) -> int:
        k = min(self.ids_per_step, self.vocab)
        if self.max_unique_per_step:
            k = min(k, self.max_unique_per_step)
        return k

    @property
    def head_capacity(self) -> int:
        """Slots kept fp32 when the arena is tiered (all of them for fp32)."""
        if self.arena_precision == "fp32":
            return self.capacity
        return min(self.capacity, max(1, int(round(self.arena_head_ratio * self.capacity))))


Arena = Union[Dict[str, torch.Tensor], ArenaStore]


@dataclasses.dataclass
class CacheState:
    cached_rows: Arena  # leaves [capacity, ...], or a tiered ArenaStore
    slot_to_row: torch.Tensor  # int32 [capacity]
    row_to_slot: torch.Tensor  # int32 [vocab]
    last_used: torch.Tensor  # int32 [capacity]
    use_count: torch.Tensor  # int32 [capacity]
    step: torch.Tensor  # int32 []
    hits: torch.Tensor  # int32 [] id-level hits
    misses: torch.Tensor  # int32 [] unique-row misses (= rows moved host->device)
    evictions: torch.Tensor  # int32 [] rows written back device->host
    uniq_overflows: torch.Tensor  # int32 [] steps whose distinct rows > unique_size
    tier_promotions: torch.Tensor  # int32 [] rows loaded INTO the fp32 head tier
    tier_demotions: torch.Tensor  # int32 [] resident rows displaced OUT of it
    # (both always 0 for a raw fp32 arena: every slot is the head then)
    tracker: freq_lib.FreqTracker

    def hit_rate(self) -> torch.Tensor:
        tot = self.hits + self.misses
        return torch.where(tot > 0, self.hits / torch.clamp(tot, min=1), 0.0)


def init_cache(
    cfg: CacheConfig, row_tree_example: Dict[str, torch.Tensor], device: torch.device
) -> CacheState:
    """Empty cache; ``row_tree_example`` leaves give per-row shapes/dtypes.
    A tiered arena starts as zeros too: zeros encode to zeros under both
    codecs."""
    cached_rows = {
        k: torch.zeros((cfg.capacity,) + tuple(v.shape), dtype=v.dtype, device=device)
        for k, v in row_tree_example.items()
    }
    if cfg.arena_precision != "fp32":
        cached_rows = ArenaStore.create(cached_rows, cfg.head_capacity, cfg.arena_precision)

    def z(*shape, fill=0):
        return torch.full(shape, fill, dtype=torch.int32, device=device)

    return CacheState(
        cached_rows=cached_rows,
        slot_to_row=z(cfg.capacity, fill=-1),
        row_to_slot=z(cfg.vocab, fill=-1),
        last_used=z(cfg.capacity),
        use_count=z(cfg.capacity),
        step=z(),
        hits=z(),
        misses=z(),
        evictions=z(),
        uniq_overflows=z(),
        tier_promotions=z(),
        tier_demotions=z(),
        tracker=freq_lib.init_tracker(cfg.vocab, device),
    )


@dataclasses.dataclass
class CachePlan:
    """A movement program plus the post-apply index image (see reference)."""

    miss_rows: torch.Tensor  # int32 [kv] rows to load (-1 inactive); kv = k (+ lookahead uniques)
    victim_slots: torch.Tensor  # int32 [kv] destination slots
    victim_rows: torch.Tensor  # int32 [kv] rows being displaced (-1 = empty)
    load_active: torch.Tensor  # bool [kv]
    evict_active: torch.Tensor  # bool [kv] displaced rows needing write-back
    slot_to_row: torch.Tensor
    row_to_slot: torch.Tensor
    last_used: torch.Tensor
    use_count: torch.Tensor
    step: torch.Tensor
    hits: torch.Tensor
    misses: torch.Tensor
    evictions: torch.Tensor
    uniq_overflows: torch.Tensor
    tier_promotions: torch.Tensor
    tier_demotions: torch.Tensor
    tracker: freq_lib.FreqTracker
    slots: torch.Tensor  # per-lane resident slot for the current batch (-1 pad)


def unique_fixed(x: torch.Tensor, k: int, fill: int) -> torch.Tensor:
    """``jnp.unique(x, size=k, fill_value=fill)``: the k smallest distinct
    values ascending, padded with ``fill``."""
    u = torch.unique(x, sorted=True)[:k]
    pad = torch.full((k - u.shape[0],), fill, dtype=x.dtype, device=x.device)
    return torch.cat([u, pad])


@contract(max_sort_size=64, int_counters=INT_COUNTERS)
def plan_prepare(
    cfg: CacheConfig,
    state: CacheState,
    rows: torch.Tensor,
    future_rows: Optional[torch.Tensor] = None,
) -> CachePlan:
    """Planning half of ``prepare``: dedup, victim selection, movement plan
    and index bookkeeping, from the index state and ids alone.

    ``future_rows`` (int32 ``[F]``, -1 padding) is a lookahead window: its
    unique rows not needed now are scheduled to load after the current
    misses, as many as fit, and the slots already holding them are pinned
    one tier above the policy key (evicted only if the current batch needs
    the room).  The pin lives in this call only.  ``misses`` counts demand
    misses; prefetched rows are stamped ``last_used = step``."""
    if future_rows is not None and future_rows.shape[0] == 0:
        future_rows = None
    k = cfg.unique_size
    capacity = state.slot_to_row.shape[0]
    vocab = state.row_to_slot.shape[0]
    valid = rows >= 0

    pre_slots = take_fill(state.row_to_slot, torch.where(valid, rows, 0), -1)
    id_hits = i32(((pre_slots >= 0) & valid).sum())

    big_rows = torch.where(valid, rows, INT_MAX)
    if cfg.use_pallas_plan:
        img = cache_ops.plan_image_impl(big_rows, state.row_to_slot, k)
        uniq, uniq_valid, uniq_sorted = img.uniq, img.uniq_valid, img.uniq_sorted
        overflow = i32(img.n_distinct > k)
        uniq_slots, miss, n_miss = img.uniq_slots, img.miss, img.n_miss
    else:
        uniq_sorted = unique_fixed(big_rows, k, INT_MAX)
        uniq_valid = uniq_sorted != INT_MAX
        uniq = torch.where(uniq_valid, uniq_sorted, -1)
        srt = torch.sort(big_rows).values
        n_distinct = ((srt[1:] != srt[:-1]) & (srt[1:] != INT_MAX)).sum() + (srt[0] != INT_MAX)
        overflow = i32(n_distinct > k)
        uniq_slots = take_fill(state.row_to_slot, torch.where(uniq_valid, uniq, 0), -1)
        miss = (uniq_slots < 0) & uniq_valid
        n_miss = i32(miss.sum())

    # the lookahead window: its unique rows that the current batch does not need
    kf = 0
    if future_rows is not None:
        kf = min(int(future_rows.shape[0]), vocab)
        fbig = torch.where(future_rows >= 0, future_rows, INT_MAX)
        if cfg.use_pallas_plan:
            fut_uniq, _ = cache_ops.dedup_impl(fbig, kf, INT_MAX)
        else:
            fut_uniq = unique_fixed(fbig, kf, INT_MAX)
        pos = torch.clamp(torch.searchsorted(uniq_sorted, fut_uniq), 0, k - 1)
        in_now = uniq_sorted[pos] == fut_uniq
        fut_valid = (fut_uniq != INT_MAX) & ~in_now
        fut_uniq = torch.where(fut_valid, fut_uniq, -1)
        fut_slots = take_fill(state.row_to_slot, torch.where(fut_valid, fut_uniq, 0), -1)
        fut_miss = (fut_slots < 0) & fut_valid
        n_fut_miss = i32(fut_miss.sum())

    # online frequency tracking (no planning decision below reads it)
    step = state.step + 1
    tracker = freq_lib.tracker_touch(state.tracker, uniq, uniq_valid, step, cfg.freq_half_life)
    if kf:
        tracker = freq_lib.tracker_touch(tracker, fut_uniq, fut_valid, step, cfg.freq_half_life)
    tracker = freq_lib.tracker_observe(tracker, id_hits, n_miss, cfg.freq_half_life)

    # victim selection (Algorithm 1 lines 15-26): needed-now slots evict
    # last, slots holding window rows just above them
    no_slots = torch.zeros((capacity,), dtype=torch.bool, device=rows.device)
    if cfg.protect_via_inverse:
        hit = (uniq_slots >= 0) & uniq_valid
        protected = scatter_drop(no_slots, uniq_slots, True, hit)
    else:
        needed = torch.where(uniq_valid, uniq, -7)
        protected = torch.isin(state.slot_to_row, needed) & (state.slot_to_row >= 0)
    key = eviction_key(cfg.policy, state.slot_to_row, state.last_used, state.use_count)
    key = torch.where(state.slot_to_row < 0, _BIG, key)  # empty slots evict first
    if kf:
        if cfg.protect_via_inverse:
            pinned = scatter_drop(no_slots, fut_slots, True, (fut_slots >= 0) & fut_valid)
        else:
            pinned = (torch.isin(state.slot_to_row, torch.where(fut_valid, fut_uniq, -7))
                      & (state.slot_to_row >= 0))
        key = torch.where(pinned, -(_BIG // 2), key)  # soon needed: evict late
    key = torch.where(protected, -_BIG, key).to(torch.int32)
    kv = min(k + kf, capacity)  # a step never loads more rows than there are slots
    if cfg.use_pallas_plan:
        victim_slots = cache_ops.victim_topk_impl(key, kv)
    else:
        victim_slots = i32(torch.argsort(key, descending=True, stable=True)[:kv])

    lane = torch.arange(kv, device=rows.device)
    if kf:
        # the current misses first, then as many window misses as fit
        # without reclaiming a pinned or protected slot
        n_prot = i32(protected.sum() + (pinned & ~protected).sum())
        n_fut_load = torch.minimum(torch.clamp_min(capacity - n_prot - n_miss, 0), n_fut_miss)
        active = lane < n_miss + n_fut_load
        if cfg.use_pallas_plan:
            fut_c = cache_ops.compact_front_impl(fut_miss, fut_uniq, kf)
            cand = cache_ops.merge_candidates_impl(img.miss_rows, n_miss, fut_c, kv)
            miss_rows = torch.where(active, cand, -1)
        else:
            perm_now = torch.argsort(torch.where(miss, 0, 1), stable=True)
            perm_fut = torch.argsort(torch.where(fut_miss, 0, 1), stable=True)
            cand_rows = torch.cat([uniq[perm_now], fut_uniq[perm_fut]])
            dev = rows.device
            cand_pri = torch.cat([
                torch.where(torch.arange(k, device=dev) < n_miss, 0, 2),
                torch.where(torch.arange(kf, device=dev) < n_fut_miss, 1, 2),
            ])
            perm = torch.argsort(cand_pri, stable=True)
            miss_rows = torch.where(active, cand_rows[perm][:kv], -1)
    else:
        active = lane < n_miss  # one victim per miss
        if cfg.use_pallas_plan:
            miss_rows = torch.where(active, img.miss_rows[:kv], -1)
        else:
            perm = torch.argsort(torch.where(miss, 0, 1), stable=True)
            miss_rows = torch.where(active, uniq[perm][:kv], -1)

    victim_rows = state.slot_to_row[victim_slots]
    evict_active = active & (victim_rows >= 0)

    # precision-tier telemetry: a load into a head slot promotes its row to
    # fp32, displacing a resident row from a head slot demotes it
    zero = torch.zeros((), dtype=torch.int32, device=rows.device)
    n_promote = n_demote = zero
    if isinstance(state.cached_rows, ArenaStore):
        in_head = victim_slots < state.cached_rows.head_capacity
        n_promote = i32((active & in_head).sum())
        n_demote = i32((evict_active & in_head).sum())

    row_to_slot = scatter_drop(state.row_to_slot, victim_rows, -1, evict_active)
    slot_to_row = scatter_drop(state.slot_to_row, victim_slots, miss_rows, active)
    row_to_slot = scatter_drop(row_to_slot, miss_rows, victim_slots, active)

    # recency / runtime-frequency bookkeeping
    touched = take_fill(row_to_slot, torch.where(uniq_valid, uniq, 0), -1)
    last_used = scatter_drop(state.last_used, touched, step, uniq_valid)
    # valid touched slots are distinct, so the reference's scatter-add is a
    # gather + set (CUDA's accumulating index_put_ serialises on the trash
    # element that every padding lane hits)
    use_count = scatter_drop(
        state.use_count, touched, take_fill(state.use_count, touched, 0) + 1, uniq_valid
    )
    use_count = scatter_drop(use_count, victim_slots, 1, active)  # loaded rows start fresh
    if kf:  # prefetched rows count as just arrived
        last_used = scatter_drop(last_used, victim_slots, step, active)

    slots = torch.where(valid, take_fill(row_to_slot, torch.where(valid, rows, 0), -1), -1)
    return CachePlan(
        miss_rows=miss_rows,
        victim_slots=victim_slots,
        victim_rows=victim_rows,
        load_active=active,
        evict_active=evict_active,
        slot_to_row=slot_to_row,
        row_to_slot=row_to_slot,
        last_used=last_used,
        use_count=use_count,
        step=step,
        hits=state.hits + id_hits,
        misses=state.misses + n_miss,
        evictions=state.evictions + i32(evict_active.sum()),
        uniq_overflows=state.uniq_overflows + overflow,
        tier_promotions=state.tier_promotions + n_promote,
        tier_demotions=state.tier_demotions + n_demote,
        tracker=tracker,
        slots=slots,
    )


INDEX_FIELDS = (
    "slot_to_row", "row_to_slot", "last_used", "use_count", "step", "hits", "misses",
    "evictions", "uniq_overflows", "tier_promotions", "tier_demotions", "tracker",
)


@contract(in_place=("full_rows", "state"), int_counters=INT_COUNTERS, max_sort_size=0,
          allowed_syncs=3)
def apply_plan(cfg: CacheConfig, full_rows, state: CacheState, plan: CachePlan) -> Tuple:
    """Execute a plan: write back displaced rows (``cfg.writeback``), load
    missed rows, install the index image.  Returns ``(full_rows, state')``;
    the arena and the host table are updated in place, so the victims are
    written back before their slots are loaded."""
    if cfg.writeback:
        full_rows = transmitter.move_rows(
            state.cached_rows, full_rows, plan.victim_slots, plan.victim_rows,
            plan.evict_active, buffer_rows=cfg.buffer_rows, dst_chunk_rows=cfg.chunk_rows,
        )
    cached_rows = transmitter.move_rows(
        full_rows, state.cached_rows, plan.miss_rows, plan.victim_slots,
        plan.load_active, buffer_rows=cfg.buffer_rows, src_chunk_rows=cfg.chunk_rows,
    )
    new_state = CacheState(
        cached_rows=cached_rows, **{f: getattr(plan, f) for f in INDEX_FIELDS}
    )
    return full_rows, new_state


def prepare(cfg: CacheConfig, full_rows, state: CacheState, rows: torch.Tensor,
            future_rows: Optional[torch.Tensor] = None):
    """Algorithm 1 ``PrepareCache``: make every row of ``rows`` resident
    (and prefetch ``future_rows``, see :func:`plan_prepare`).  Returns
    ``(full_rows', state', slots)``."""
    plan = plan_prepare(cfg, state, rows, future_rows=future_rows)
    full_rows, new_state = apply_plan(cfg, full_rows, state, plan)
    return full_rows, new_state, plan.slots


def lookup_slots(state: CacheState, slots: torch.Tensor, leaf: str = "weight") -> torch.Tensor:
    """Gather cached rows by slot; -1 (padding) lanes return zero rows.  On
    a tiered arena the gather decodes on read."""
    if isinstance(state.cached_rows, ArenaStore):
        return state.cached_rows.gather_slots(slots)[leaf]
    return take_fill(state.cached_rows[leaf], slots, 0)


@contract(in_place=("full_rows",), int_counters=INT_COUNTERS, max_sort_size=0, allowed_syncs=3)
def flush(cfg: CacheConfig, full_rows, state: CacheState) -> Tuple:
    """Write every resident row back to the host table (checkpoint barrier).
    The table becomes authoritative; the cache stays warm.  Returns
    ``(full_rows, state)``; the table is updated in place."""
    capacity = state.slot_to_row.shape[0]
    slots = torch.arange(capacity, dtype=torch.int32, device=state.slot_to_row.device)
    rows = state.slot_to_row
    full_rows = transmitter.move_rows(
        state.cached_rows, full_rows, slots, rows, rows >= 0, buffer_rows=cfg.buffer_rows,
        dst_chunk_rows=cfg.chunk_rows,
    )
    return full_rows, state


@contract(in_place=("state",), int_counters=INT_COUNTERS, max_sort_size=0, allowed_syncs=1)
def warmup(cfg: CacheConfig, full_rows, state: CacheState) -> Tuple:
    """Paper §4.3 cache warm-up: pre-fill with the hottest (lowest-rank) rows."""
    capacity = state.slot_to_row.shape[0]
    vocab = state.row_to_slot.shape[0]
    dev = state.slot_to_row.device
    slots = torch.arange(capacity, dtype=torch.int32, device=dev)
    active = slots < min(capacity, vocab)
    rows = torch.where(active, slots, -1)
    cached_rows = transmitter.move_rows(
        full_rows, state.cached_rows, rows, slots, active, buffer_rows=cfg.buffer_rows,
        src_chunk_rows=cfg.chunk_rows,
    )
    return full_rows, dataclasses.replace(
        state,
        cached_rows=cached_rows,
        slot_to_row=rows,
        row_to_slot=scatter_drop(state.row_to_slot, rows, slots, active),
    )
