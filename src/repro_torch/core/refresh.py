"""Incremental re-ranking refresh, the adaptive half of the frequency module
(port of ``repro.core.refresh``).

The paper's FREQ_LFU rank is frozen at init, so when the hot set drifts the
cache keeps protecting yesterday's hot rows.  Every N steps a host-side
pass reads the online decayed counters (``core.freq.FreqTracker``, touched
by every ``cache.plan_prepare``), re-ranks, and applies a bounded
incremental permutation: at most ``max_swaps`` rank pairs, and only pairs
that cross the cache-capacity boundary.

A refresh is pure reindexing.  Each swap

  1. writes the pair's dirty resident rows back to the host tier at their
     OLD ranks (``transmitter.move_rows``; skipped with ``writeback=False``);
  2. invalidates their residency (the rows re-fault at their new ranks);
  3. swaps the host rows (payload and sideband still encoded: bit-exact for
     every codec) and the tracker's ``score`` / ``last_touch``, adds to the
     int32 ``refresh_swaps`` / ``refresh_rows`` counters and remaps
     ``idx_map`` through the permutation.

Every raw id still resolves to the value it resolved to before (bitwise
for an fp32 host tier; a dirty row of an fp16 / int8 tier pays one encode).

Where the reference pads the swap set to a static ``max_swaps`` and jits
the surgery, the port plans on the host and touches only the swapped rows:
the pinned host table is permuted in place (2 x swaps rows), never
reallocated or re-pinned.  Like ``apply_plan``, a refresh updates the
arena and the host table in place: the state passed in must not be used
again.

Sharded slabs use the same plan.  Physical rows live at fixed ``(owner
shard, local row)`` homes keyed by rank, so a swap moves row content
between the two ranks' homes; a pair whose homes lie on two shards is a
cross-shard exchange, metered by ``RefreshConfig.exchange_budget``.  With
one shard the pass is bitwise the unsharded one.  ``apply_rebalance``
re-homes every rank of a sharded slab (``ShardedEmbeddingCollection``'s
``rebalance_threshold``).

Planning is numpy and bitwise the reference's: ``plan_swaps`` selects the
k coldest hot and k hottest cold ranks by an O(n) partition at the k-th
score and sorts only those candidates, which gives the first k entries of
the reference's full ``lexsort`` (the same rank tie-breaks).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.contracts import INT_COUNTERS, contract
from repro_torch.core import cache as cache_lib
from repro_torch.core import freq as freq_lib
from repro_torch.core import transmitter
from repro_torch.core.lanes import i32
from repro_torch.store.host_store import HostStore

__all__ = [
    "RefreshConfig",
    "RefreshReport",
    "plan_swaps",
    "plan_cached",
    "plan_sharded",
    "homes",
    "sharded_scores",
    "apply_swaps",
    "apply_swaps_sharded",
    "refresh_cached_slab",
    "refresh_sharded_slab",
    "apply_rebalance",
]


@dataclasses.dataclass(frozen=True)
class RefreshConfig:
    """Knobs of one refresh pass (per slab)."""

    max_swaps: int = 256  # bounded top-K rank pairs per slab per refresh
    min_gain: float = 0.0  # extra decayed mass a cold row must carry over the
    # hot row it displaces (hysteresis; 0.0 only suppresses exact ties)
    exchange_budget: Optional[int] = None  # sharded: max host rows moved
    # ACROSS shards per refresh (2 per cross-shard pair); None = unbounded,
    # 0 = same-shard swaps only.  Unsharded slabs ignore it.
    rebalance_threshold: Optional[float] = None  # sharded: when the live
    # routed imbalance (max / mean of the shards' decayed tracker mass)
    # exceeds this after the swap pass, re-run ``assign_devices`` on the
    # live scores and re-home every rank.  None = homes stay put.


@dataclasses.dataclass
class RefreshReport:
    """Host-side summary of one collection-wide refresh pass (per slab)."""

    swaps: Dict[str, int] = dataclasses.field(default_factory=dict)
    rows_moved: Dict[str, int] = dataclasses.field(default_factory=dict)
    cross_shard_rows: Dict[str, int] = dataclasses.field(default_factory=dict)
    deferred_swaps: Dict[str, int] = dataclasses.field(default_factory=dict)
    rebalance_moves: Dict[str, int] = dataclasses.field(default_factory=dict)
    rebalance_imbalance: Dict[str, float] = dataclasses.field(default_factory=dict)

    def add(self, slab: str, stats: Dict[str, Any]) -> None:
        self.swaps[slab] = stats["swaps"]
        self.rows_moved[slab] = stats["rows_moved"]
        self.cross_shard_rows[slab] = stats.get("cross_shard_rows", 0)
        self.deferred_swaps[slab] = stats.get("deferred_swaps", 0)
        self.rebalance_moves[slab] = stats.get("rebalance_moves", 0)
        self.rebalance_imbalance[slab] = stats.get("rebalance_imbalance", 1.0)

    @property
    def total_swaps(self) -> int:
        return sum(self.swaps.values())

    @property
    def total_rows_moved(self) -> int:
        return sum(self.rows_moved.values())


def _first_k(key: np.ndarray, idx: np.ndarray, k: int, ties_desc: bool) -> np.ndarray:
    """``idx[np.lexsort((-idx if ties_desc else idx, key))[:k]]`` for an
    ascending ``idx``, without sorting all of ``key``: a partition at the
    k-th smallest key keeps every lane below it and, of the lanes tied at
    it, the ones the rank tie-break puts first (the largest ranks when
    ``ties_desc``, else the smallest); only those are sorted."""
    n = key.size
    if k < n:
        t = np.partition(key, k - 1)[k - 1]
        below = np.flatnonzero(key < t)
        tied = np.flatnonzero(key == t)
        need = k - below.size
        cand = np.concatenate([below, tied[tied.size - need:] if ties_desc else tied[:need]])
    else:
        cand = np.arange(n)
    order = np.lexsort((-idx[cand] if ties_desc else idx[cand], key[cand]))
    return idx[cand[order[:k]]]


def plan_swaps(
    scores: np.ndarray,
    hot: np.ndarray,
    max_swaps: int,
    min_gain: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pick the bounded set of capacity-boundary rank swaps.

    ``scores`` are the decayed access masses in current rank order and
    ``hot`` marks the ranks inside the cache-capacity (warm-set) boundary.
    Pairs the coldest hot ranks (score ties: larger rank first) against the
    hottest cold ranks (ties: smaller rank first) and keeps a pair only
    while the cold row's mass exceeds the hot row's by more than
    ``min_gain``; gains are non-increasing along the pairing, so the kept
    set is a prefix.  Returns ``(a, b)``: demoted hot ranks and promoted
    cold ranks, pairwise (int64)."""
    hot = np.asarray(hot, bool)
    hot_idx = np.nonzero(hot)[0]
    cold_idx = np.nonzero(~hot)[0]
    k = min(int(max_swaps), hot_idx.size, cold_idx.size)
    if k <= 0:
        return np.empty((0,), np.int64), np.empty((0,), np.int64)
    s = np.asarray(scores, np.float64)
    a = _first_k(s[hot_idx], hot_idx, k, ties_desc=True)
    b = _first_k(-s[cold_idx], cold_idx, k, ties_desc=False)
    keep = s[b] > s[a] + min_gain
    n = int(np.argmax(~keep)) if not keep.all() else k  # the first rejected pair
    return a[:n].astype(np.int64), b[:n].astype(np.int64)


def _host_rows(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _swap_leaf_(leaf: torch.Tensor, to: torch.Tensor, frm: torch.Tensor) -> None:
    """In place: row ``to[i]`` of ``leaf`` takes row ``frm[i]``'s content
    (the rows are read before any is written)."""
    leaf.index_copy_(0, to, leaf.index_select(0, frm))


def _permute_store_(full: HostStore, to: torch.Tensor, frm: torch.Tensor) -> None:
    """Swap host rows in place, payload and sideband still encoded."""
    for leaf in (*full.data.values(), *full.sideband.values()):
        _swap_leaf_(leaf, to.to(leaf.device), frm.to(leaf.device))


def _permuted(x: torch.Tensor, to: torch.Tensor, frm: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` with row ``to[i]`` taken from row ``frm[i]``."""
    out = x.clone()
    _swap_leaf_(out, to.to(x.device), frm.to(x.device))
    return out


def _remap(idx_map: torch.Tensor, a: np.ndarray, b: np.ndarray) -> torch.Tensor:
    """``idx_map`` through the rank permutation that swaps ``a[i]`` and
    ``b[i]``."""
    perm = np.arange(idx_map.shape[0], dtype=np.int32)
    perm[a] = b
    perm[b] = a
    return torch.from_numpy(perm).to(idx_map.device)[idx_map.long()]


# ---------------------------------------------------------------------------
# unsharded slab surgery
# ---------------------------------------------------------------------------


@contract(int_counters=INT_COUNTERS, allowed_syncs=2)
def apply_swaps(
    full: HostStore,
    cache: cache_lib.CacheState,
    idx_map: torch.Tensor,
    a: np.ndarray,
    b: np.ndarray,
    *,
    buffer_rows: int,
    writeback: bool,
) -> Tuple[HostStore, cache_lib.CacheState, torch.Tensor]:
    """State surgery of one swap set: write back, invalidate, permute,
    remap.  Returns ``(full, cache', idx_map')``; the host table is updated
    in place."""
    to = torch.from_numpy(np.concatenate([a, b]).astype(np.int64))
    frm = torch.from_numpy(np.concatenate([b, a]).astype(np.int64))
    involved = to.to(cache.row_to_slot.device)
    # 1) write the pairs' dirty resident rows back at their OLD ranks
    slots = cache.row_to_slot.index_select(0, involved)
    active = slots >= 0
    if writeback:
        full = transmitter.move_rows(cache.cached_rows, full, slots, i32(involved), active,
                                     buffer_rows=buffer_rows)
    # 2) invalidate residency (the rows re-fault at their new ranks)
    slot_to_row = cache.slot_to_row.clone()
    slot_to_row[slots[active].long()] = -1
    row_to_slot = cache.row_to_slot.index_fill(0, involved, -1)
    # 3) swap host rows and tracker slices; remap idx_map
    _permute_store_(full, to, frm)
    tr = cache.tracker
    tr = dataclasses.replace(
        tr,
        score=_permuted(tr.score, to, frm),
        last_touch=_permuted(tr.last_touch, to, frm),
        refresh_swaps=tr.refresh_swaps + int(a.size),
        refresh_rows=tr.refresh_rows + int(2 * a.size),
    )
    cache = dataclasses.replace(cache, slot_to_row=slot_to_row, row_to_slot=row_to_slot,
                                tracker=tr)
    return full, cache, _remap(idx_map, a, b)


def plan_cached(ccfg: cache_lib.CacheConfig, slab, cfg: RefreshConfig
                ) -> Tuple[np.ndarray, np.ndarray]:
    """The swap plan of an unsharded slab: its tracker crosses to the host
    once, every rank's decayed mass is taken as of the plan clock, and the
    hot set is the ranks below the capacity."""
    cache = slab.cache
    capacity = int(cache.slot_to_row.shape[0])
    vocab = int(cache.row_to_slot.shape[0])
    tr = cache.tracker
    scores = freq_lib.decayed_scores(_host_rows(tr.score), _host_rows(tr.last_touch),
                                     int(cache.step), ccfg.freq_half_life)
    return plan_swaps(scores, np.arange(vocab) < capacity, cfg.max_swaps, cfg.min_gain)


def refresh_cached_slab(
    ccfg: cache_lib.CacheConfig, slab, cfg: RefreshConfig, writeback: bool = True
) -> Tuple[Any, Dict[str, int]]:
    """One refresh pass over an unsharded ``collection.CachedSlab``:
    :func:`plan_cached`, then :func:`apply_swaps`.

    ``ccfg`` is the slab's cache config (half-life, staging rounds); the
    geometry comes from the state.  ``writeback=False`` (a read-only serve
    state, whose resident rows are clean) skips the write-back.  Returns
    ``(slab', stats)``; a pass with no swap returns the slab unchanged."""
    a, b = plan_cached(ccfg, slab, cfg)
    if a.size == 0:
        return slab, {"swaps": 0, "rows_moved": 0}
    full, new_cache, idx_map = apply_swaps(slab.full, slab.cache, slab.idx_map, a, b,
                                           buffer_rows=ccfg.buffer_rows, writeback=writeback)
    new_slab = dataclasses.replace(slab, full=full, cache=new_cache, idx_map=idx_map)
    return new_slab, {"swaps": int(a.size), "rows_moved": int(2 * a.size)}


# ---------------------------------------------------------------------------
# sharded slab surgery
# ---------------------------------------------------------------------------


def _flat(full: HostStore) -> HostStore:
    """A stacked ``[S, vs, ...]`` store as one flat ``[S * vs, ...]`` view:
    flat row ``owner * vs + local`` is a rank's home."""
    return full.view(lambda v: v.reshape((-1,) + tuple(v.shape[2:])))


def _per_shard(cache: cache_lib.CacheState, full: HostStore, s: int):
    from repro_torch.core.sharded import _shard

    return full.shard(s), _shard(cache, s)


@contract(int_counters=INT_COUNTERS, allowed_syncs=4)
def apply_swaps_sharded(
    full: HostStore,
    cache: cache_lib.CacheState,
    idx_map: torch.Tensor,
    rep,
    owner: np.ndarray,
    local: np.ndarray,
    a: np.ndarray,
    b: np.ndarray,
    *,
    buffer_rows: int,
    writeback: bool,
):
    """Sharded surgery of one swap set: per-shard write-back + invalidate
    on the views ``[s]`` of the stacked state, then the content exchange
    between the swapped ranks' fixed flat homes.

    Replicated boundary (``rep``, ranks < K): a demoted replicated rank's
    arena row and tracker slice are authoritative, so they are pushed into
    its home before the exchange (which carries them to the promoted rank's
    old home); after it, the arena pulls the promoted rank's row and
    tracker slice from the swapped home.  Returns ``(full, cache', idx_map',
    rep')``."""
    S, vs = cache.row_to_slot.shape
    dev = cache.row_to_slot.device
    K = int(rep.rows.shape[0])
    involved = np.concatenate([a, b])
    inv_owner, inv_local = owner[involved], local[involved]
    r2s = cache.row_to_slot.clone()
    s2r = cache.slot_to_row.clone()
    for s in range(S):
        rows_s = torch.from_numpy(inv_local[inv_owner == s]).to(dev)
        if not rows_s.numel():
            continue
        full_s, cache_s = _per_shard(cache, full, s)
        slots = cache_s.row_to_slot.index_select(0, rows_s)
        act = slots >= 0
        if writeback:
            transmitter.move_rows(cache_s.cached_rows, full_s, slots, i32(rows_s), act,
                                  buffer_rows=buffer_rows)
        r2s[s].index_fill_(0, rows_s, -1)
        s2r[s][slots[act].long()] = -1
    flat = _flat(full)
    tr = cache.tracker
    score = tr.score.reshape(-1).clone()
    last_touch = tr.last_touch.reshape(-1).clone()
    pa = owner[a] * vs + local[a]
    pb = owner[b] * vs + local[b]
    am = a < K  # demoted replicated ranks
    if am.any():
        src = torch.from_numpy(a[am]).to(dev)
        dst = torch.from_numpy(pa[am]).to(dev)
        if writeback:
            transmitter.write_rows({"weight": rep.rows.index_select(0, src)}, flat, i32(dst),
                                   torch.ones(dst.shape, dtype=torch.bool, device=dev),
                                   buffer_rows=buffer_rows)
        score[dst] = rep.score[src]
        last_touch[dst] = rep.last_touch[src]
    # swap host content (encoded) and tracker slices between the two homes
    to = torch.from_numpy(np.concatenate([pa, pb]).astype(np.int64))
    frm = torch.from_numpy(np.concatenate([pb, pa]).astype(np.int64))
    _permute_store_(flat, to, frm)
    score = _permuted(score, to, frm).reshape(S, vs)
    last_touch = _permuted(last_touch, to, frm).reshape(S, vs)
    # per-shard counter shares: swaps by the demoted rank's home, rows by
    # each changed home; both sum to the slab's totals
    swaps_ps = torch.from_numpy(np.bincount(owner[a], minlength=S).astype(np.int32)).to(dev)
    rows_ps = torch.from_numpy(np.bincount(inv_owner, minlength=S).astype(np.int32)).to(dev)
    tr = dataclasses.replace(tr, score=score, last_touch=last_touch,
                             refresh_swaps=tr.refresh_swaps + swaps_ps,
                             refresh_rows=tr.refresh_rows + rows_ps)
    cache = dataclasses.replace(cache, row_to_slot=r2s, slot_to_row=s2r, tracker=tr)
    if am.any():
        # the home of each demoted rank now holds the promoted rank's content
        arena_dst = torch.from_numpy(a[am]).to(dev)
        homes = torch.from_numpy(pa[am]).to(dev)
        rows = rep.rows.clone()
        transmitter.move_rows(flat, {"weight": rows}, i32(homes), i32(arena_dst),
                              torch.ones(homes.shape, dtype=torch.bool, device=dev),
                              buffer_rows=buffer_rows)
        rep = dataclasses.replace(
            rep, rows=rows,
            score=rep.score.index_copy(0, arena_dst, score.reshape(-1)[homes]),
            last_touch=rep.last_touch.index_copy(0, arena_dst, last_touch.reshape(-1)[homes]),
        )
    return full, cache, _remap(idx_map, a, b), rep


def homes(slab) -> Tuple[np.ndarray, np.ndarray]:
    """A sharded slab's rank -> (owner shard, local row), on the host."""
    return (_host_rows(slab.rank_owner).astype(np.int64),
            _host_rows(slab.rank_local).astype(np.int64))


def sharded_scores(slab, half_life: int, owner: np.ndarray, local: np.ndarray) -> np.ndarray:
    """Every rank's decayed mass (float64, rank order) read off the
    per-shard trackers at the ranks' homes ``(owner, local)``, each shard
    as of its own plan clock."""
    tr = slab.cache.tracker
    steps = _host_rows(slab.cache.step).astype(np.float64)
    local_scores = freq_lib.decayed_scores(_host_rows(tr.score), _host_rows(tr.last_touch),
                                           steps[:, None], half_life)
    return local_scores[owner, local]


def plan_sharded(ccfg: cache_lib.CacheConfig, slab, cfg: RefreshConfig, owner: np.ndarray,
                 local: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int]:
    """The swap plan of a sharded slab whose ranks live at ``(owner,
    local)`` (:func:`homes`), global over its shards: every rank's mass read
    off its home shard's tracker (the replicated ranks' off the arena's),
    the hot set the ranks within their shard's capacity or replicated.
    With ``cfg.exchange_budget``, cross-shard pairs are kept while
    ``cumsum(cross) * 2 <= budget`` (same-shard pairs always); returns
    ``(a, b, deferred)``, the pairs kept and the count deferred."""
    rep = slab.rep
    K = int(rep.rows.shape[0])
    cap = int(slab.cache.slot_to_row.shape[1])
    scores = sharded_scores(slab, ccfg.freq_half_life, owner, local)
    if K:  # replicated ranks bypass the per-shard plans: their signal is the arena's
        scores[:K] = freq_lib.decayed_scores(_host_rows(rep.score), _host_rows(rep.last_touch),
                                             float(rep.step), ccfg.freq_half_life)
    hot = (local < cap) | (np.arange(owner.shape[0]) < K)
    a, b = plan_swaps(scores, hot, cfg.max_swaps, cfg.min_gain)
    if not a.size or cfg.exchange_budget is None:
        return a, b, 0
    cross = owner[a] != owner[b]
    keep = ~cross | (np.cumsum(cross) * 2 <= cfg.exchange_budget)
    return a[keep], b[keep], int((~keep).sum())


def refresh_sharded_slab(
    ccfg: cache_lib.CacheConfig, slab, cfg: RefreshConfig, writeback: bool = True
) -> Tuple[Any, Dict[str, int]]:
    """One refresh pass over a ``sharded.ShardedSlab``: :func:`plan_sharded`,
    then :func:`apply_swaps_sharded`.  Homes stay fixed, so the balance
    ``assign_devices`` gave the hot homes passes to whichever rows are hot
    now."""
    owner, local = homes(slab)
    a, b, deferred = plan_sharded(ccfg, slab, cfg, owner, local)
    if a.size == 0:
        return slab, {"swaps": 0, "rows_moved": 0, "cross_shard_rows": 0,
                      "deferred_swaps": deferred}
    full, new_cache, idx_map, new_rep = apply_swaps_sharded(
        slab.full, slab.cache, slab.idx_map, slab.rep, owner, local, a, b,
        buffer_rows=ccfg.buffer_rows, writeback=writeback)
    new_slab = dataclasses.replace(slab, full=full, cache=new_cache, idx_map=idx_map,
                                   rep=new_rep)
    return new_slab, {
        "swaps": int(a.size),
        "rows_moved": int(2 * a.size),
        "cross_shard_rows": int(2 * np.sum(owner[a] != owner[b])),
        "deferred_swaps": deferred,
    }


# ---------------------------------------------------------------------------
# traffic-aware re-homing (sharded rebalance)
# ---------------------------------------------------------------------------


@contract(int_counters=INT_COUNTERS, allowed_syncs=6)
def apply_rebalance(
    full: HostStore,
    cache: cache_lib.CacheState,
    src_for_dest: np.ndarray,
    *,
    buffer_rows: int,
    writeback: bool,
) -> Tuple[HostStore, cache_lib.CacheState]:
    """Re-home surgery of one sharded slab: every shard writes its resident
    rows back (the dirty copy is authoritative) and drops all residency,
    then the host rows and tracker move old home -> new home:
    ``new[i] = old[src_for_dest[i]]`` over the flat ``[S * vs]`` rows.

    Only the rows whose home changes are gathered (one copy of them, at
    most one copy of the slab's host tier) and written in place, which is
    the reference's full gather bit for bit: encoded payload and sideband
    move as they are.  ``idx_map`` is untouched (re-homing, not
    re-ranking); the caller installs the new homes and re-warms the
    emptied caches."""
    S, _ = cache.row_to_slot.shape
    cap = cache.slot_to_row.shape[1]
    dev = cache.row_to_slot.device
    for s in range(S):
        full_s, cache_s = _per_shard(cache, full, s)
        if writeback:
            rows = cache_s.slot_to_row
            slots = torch.arange(cap, dtype=torch.int32, device=dev)
            transmitter.move_rows(cache_s.cached_rows, full_s, slots, rows, rows >= 0,
                                  buffer_rows=buffer_rows)
    moved = np.flatnonzero(src_for_dest != np.arange(src_for_dest.size))
    to = torch.from_numpy(moved.astype(np.int64))
    frm = torch.from_numpy(src_for_dest[moved].astype(np.int64))
    _permute_store_(_flat(full), to, frm)
    tr = cache.tracker
    tr = dataclasses.replace(
        tr,
        score=_permuted(tr.score.reshape(-1), to, frm).reshape(tr.score.shape),
        last_touch=_permuted(tr.last_touch.reshape(-1), to, frm).reshape(tr.last_touch.shape),
    )
    cache = dataclasses.replace(cache, slot_to_row=torch.full_like(cache.slot_to_row, -1),
                                row_to_slot=torch.full_like(cache.row_to_slot, -1), tracker=tr)
    return full, cache
