"""Hybrid-parallel sharded ``EmbeddingCollection`` (port of
``repro.core.sharded``) in its single-card layout.

The paper scales its cache "to multiple GPUs in combination with the widely
used hybrid parallel training approaches": dense parameters train data
parallel while each cached slab is split over ``S`` shards, each with its
own cache arena and its own slice of the host table.  The reference stacks
every shard's state along a leading ``[S, ...]`` axis and runs the per-shard
cache ops under ``jax.vmap``; on one device that stacked state simply lives
on the device.  The port keeps that layout on one card:

* ``PlacementPlanner.assign_devices`` maps every frequency rank of a slab to
  a shard (``rank_owner``) and a row there (``rank_local``).
* ``ShardedSlab`` holds ONE pinned ``[S, rows_per_shard, dim]`` host table
  and a ``CacheState`` whose leaves all lead with ``[S]``.  A per-shard cache
  op runs on the views ``leaf[s]`` (a loop over shards in place of ``vmap``):
  the transmitter moves rows in place in the stacked arena and table, and
  the per-shard plans' index images are stacked into the new state.
* ``plan_prepare`` dedups the batch's ranks, routes them, builds the
  ``[S, U]`` per-shard routing image (the bucketize kernel on the card) and
  plans each shard; addresses are combined ``owner * capacity + slot``.
* ``gather`` reads the combined addresses off the flattened ``[S * capacity,
  dim]`` arena with one ``index_select`` per slab: the values of the
  reference's per-shard takes summed over shards (each lane has one owner),
  with one dense gradient.  An ``exchange_codec`` encodes and decodes the
  gathered rows (a row codec is row-wise, so this is the reference's
  encode of the whole arena restricted to the rows read), with a
  straight-through gradient.
* ``replicate_top_k`` keeps the K hottest ranks in a replicated ``RepArena``
  (arena addresses ``S * capacity + rank``), outside the exchange.
* The budget mode (``create(budget_bytes=)``, a per-device budget): the
  planner's DEVICE tables stay whole (replicated in the reference's mesh;
  here one copy on the card) and only the CACHED / GROUPED slabs shard.
  Each slab's host tier takes its own codec (fp32 / fp16 / int8 / "auto",
  resolved from the slab's global geometry), its int8 sideband stacked
  ``[S, rows_per_shard, 2]`` with the payload.  The card holds all S
  shards' arenas, so it holds S times the per-device arena bytes that
  ``device_bytes()["device_per_shard"]`` prices.
* ``plan_prepare(fb_future=)`` merges a lookahead window per shard: one
  dedup'd image of the window, routed (a second bucketize per plan) and
  handed to each shard's plan as its ``future_rows``.

* ``refresh`` plans the re-ranking globally and exchanges row content
  between the swapped ranks' fixed homes (``core.refresh``); with
  ``rebalance_threshold`` it re-homes every rank of a slab whose live
  traffic has drifted out of balance.

The one-process-per-GPU placement over NCCL comes with a later slice;
``shard_specs`` (JAX PartitionSpecs) has no counterpart here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import cache as cache_lib
from repro_torch.core import freq as freq_lib
from repro_torch.core import refresh as refresh_lib
from repro_torch.core import transmitter
from repro_torch.core.collection import (
    ArenaConfig,
    CollectionState,
    EmbeddingCollection,
    FeatureBatch,
    PlacementPlan,
    PlacementPlanner,
    ShardAssignment,
    TableConfig,
    _CachedSlabSpec,
    draw_chunks,
    slab_counts,
)
from repro_torch.core.lanes import i32, scatter_drop, take_fill
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.cache_ops import ops as cache_ops
from repro_torch.kernels.cache_ops import ref as cache_ref
from repro_torch.store.arena import tiered_arena_bytes
from repro_torch.store.codec import get_codec
from repro_torch.store.host_store import HostStore
from repro_torch.store.policy import PrecisionPolicy

__all__ = [
    "RepArena",
    "ShardedSlab",
    "ShardedCollectionPlan",
    "ShardedEmbeddingCollection",
    "flat_store",
]

# padding sentinel of the dedup'd rank buffer: sorts after every real rank
_PAD_RANK = cache_ops.PAD_RANK


def flat_store(store: HostStore) -> HostStore:
    """A stacked ``[S, vs, ...]`` store viewed as one flat ``[S * vs, ...]``
    store: flat row ``owner * vs + local`` is a rank's home."""
    return store.view(lambda v: v.reshape((-1,) + tuple(v.shape[2:])))


def _stack_store(store: HostStore, S: int, vs: int) -> HostStore:
    """Inverse of :func:`flat_store`: a flat ``[S * vs, ...]`` store viewed
    as the stacked ``[S, vs, ...]`` layout."""
    return store.view(lambda v: v.reshape((S, vs) + tuple(v.shape[1:])))


def _shard(tree: Any, s: int) -> Any:
    """Shard ``s`` of a stacked state, plan or arena: every tensor leaf
    indexed by ``[s]`` (views, so in-place writes reach the stack)."""
    if isinstance(tree, torch.Tensor):
        return tree[s]
    if isinstance(tree, dict):
        return {k: _shard(v, s) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(
            tree, **{f.name: _shard(getattr(tree, f.name), s) for f in dataclasses.fields(tree)})
    return tree


def _stack(trees: Sequence[Any]) -> Any:
    """Per-shard trees of one structure -> one tree of ``[S, ...]`` leaves."""
    t0 = trees[0]
    if isinstance(t0, torch.Tensor):
        return torch.stack(list(trees))
    if isinstance(t0, dict):
        return {k: _stack([t[k] for t in trees]) for k in t0}
    if dataclasses.is_dataclass(t0):
        return dataclasses.replace(t0, **{
            f.name: _stack([getattr(t, f.name) for t in trees]) for f in dataclasses.fields(t0)})
    return t0


def _with_index(cache: cache_lib.CacheState, index: Any) -> cache_lib.CacheState:
    """``cache`` with its index fields (everything but the arena, which the
    per-shard ops updated in place) from ``index``: a stacked plan, or a
    list of per-shard states to stack."""
    if isinstance(index, list):
        return dataclasses.replace(cache, **{
            f: _stack([getattr(t, f) for t in index]) for f in cache_lib.INDEX_FIELDS})
    return dataclasses.replace(cache, **{f: getattr(index, f) for f in cache_lib.INDEX_FIELDS})


class _EncodedExchange(torch.autograd.Function):
    """The compressed row leg of the exchange: the gathered rows encode and
    decode through the wire codec (what crosses between shards), and the
    gradient goes straight through to the fp32 arena rows as the plain
    gather's would (a scatter-add on the gathered lanes)."""

    @staticmethod
    def forward(ctx, w_flat: torch.Tensor, idx: torch.Tensor, codec: str) -> torch.Tensor:
        ctx.save_for_backward(idx)
        ctx.rows = w_flat.shape[0]
        c = get_codec(codec)
        payload, side = c.encode(take_fill(w_flat, idx, 0.0))
        return c.decode(payload, side, w_flat.dtype)

    @staticmethod
    def backward(ctx, ct: torch.Tensor):
        (idx,) = ctx.saved_tensors
        n = ctx.rows
        ok = (idx >= 0) & (idx < n)
        grad = ct.new_zeros((n + 1,) + tuple(ct.shape[1:]))
        grad.index_add_(0, torch.where(ok, idx, n).to(torch.int64), ct)
        return grad[:n], None, None


@dataclasses.dataclass
class RepArena:
    """The replicated hot head of one sharded slab: ``rows[r]`` is the
    authoritative fp32 row of rank ``r < K``, with its own lazy-decay
    tracker slice (replicated lanes bypass the per-shard plans)."""

    rows: torch.Tensor  # [K, dim]
    score: torch.Tensor  # float32 [K] decayed mass, exact at last_touch
    last_touch: torch.Tensor  # int32 [K]
    step: torch.Tensor  # int32 [] plan clock (ticks with apply_plan)


@dataclasses.dataclass
class ShardedSlab:
    """One cached slab split over ``S`` shards (leading dim = shard)."""

    full: HostStore  # one table, data [S, rows_per_shard, dim] (pinned whole)
    cache: cache_lib.CacheState  # every leaf [S, ...]
    idx_map: torch.Tensor  # int32 [vocab] raw id -> frequency rank
    rank_owner: torch.Tensor  # int32 [vocab] rank -> owning shard
    rank_local: torch.Tensor  # int32 [vocab] rank -> row on the owner
    routed_lanes: torch.Tensor  # int32 [S] cumulative id lanes routed per shard
    rep: RepArena  # zero-length leaves when replicate_top_k = 0


@dataclasses.dataclass
class ShardedCollectionPlan:
    """Per-shard cache plans (leaves ``[S, ...]``), combined addresses per
    feature (``owner * capacity + slot``, replicated lanes past
    ``S * capacity``, -1 padding), the lanes routed to each shard this step,
    and each slab's dedup'd rank buffer (-1 padding)."""

    slab_plans: Dict[str, cache_lib.CachePlan]
    routed: Dict[str, torch.Tensor]
    addresses: Dict[str, torch.Tensor]
    uniq_ranks: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    # the lookahead window's addresses and unresident lanes, summed over
    # the shards (``CollectionPlan``'s fields)
    future_addresses: Tuple[Dict[str, torch.Tensor], ...] = ()
    future_unresident: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.zeros((), dtype=torch.int32))
    writeback: bool = True


class ShardedEmbeddingCollection(EmbeddingCollection):
    """``EmbeddingCollection`` with its cached slab split over
    ``num_shards`` shards; the same keyed-feature surface, so the models and
    the trainer use it unchanged."""

    def __init__(
        self,
        tables: Sequence[TableConfig],
        plan: PlacementPlan,
        num_shards: int,
        replicate_top_k: int = 0,
        exchange_codec: Optional[str] = None,
        max_routed_per_shard: int = 0,
    ):
        super().__init__(tables, plan)
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        self.num_shards = int(num_shards)
        # 0: the full-width [S, U] image; > 0: a dense [S, W] image per step
        # (lanes past W count into uniq_overflows)
        self.max_routed_per_shard = max(int(max_routed_per_shard), 0)
        self.replicate_top_k = max(int(replicate_top_k), 0)
        # None / "fp32": the raw rows (fp32's codec is the identity)
        if exchange_codec in (None, "fp32"):
            self.exchange_codec: Optional[str] = None
        else:
            get_codec(exchange_codec)  # fail fast on typos
            self.exchange_codec = exchange_codec
        # each cached slab's rank -> (shard, row) placement, from init or the
        # last rebalance
        self.assignments: Dict[str, ShardAssignment] = {}

    @classmethod
    def create(
        cls,
        tables: Sequence[TableConfig],
        num_shards: int = 1,
        budget_bytes: Optional[int] = None,
        replicate_top_k: int = 0,
        exchange_codec: Optional[str] = None,
        max_routed_per_shard: int = 0,
        counts: Optional[Mapping[str, np.ndarray]] = None,
        planner: Optional[PlacementPlanner] = None,
        **arena_kw,
    ) -> "ShardedEmbeddingCollection":
        """Plan and build, like ``EmbeddingCollection.create`` plus the
        shard count: without a budget the paper's single arena split over
        ``num_shards`` shards; with ``budget_bytes`` (the PER-DEVICE budget)
        or a ``planner``, its DEVICE / CACHED / GROUPED plan, the cached
        slabs sharded."""
        if planner is None and budget_bytes is None:
            plan = PlacementPlan.single_arena(tables, **arena_kw)
        else:
            planner = planner or PlacementPlanner(
                budget_bytes,
                arena=ArenaConfig(**arena_kw),
                host_precision=arena_kw.get("host_precision"),
                arena_precision=arena_kw.get("arena_precision"),
                arena_head_ratio=arena_kw.get("arena_head_ratio", 0.25),
            )
            plan = planner.plan(tables, counts=counts)
        return cls(tables, plan, num_shards, replicate_top_k, exchange_codec,
                   max_routed_per_shard)

    # ----- per-shard geometry ----------------------------------------------

    def rows_per_shard(self, spec: _CachedSlabSpec) -> int:
        return -(-spec.vocab // self.num_shards)

    def shard_capacity(self, spec: _CachedSlabSpec) -> int:
        """The slab's cache ratio applied to one shard's rows, floored at one
        batch's unique rows (every lane may land on one shard), or at the
        routed-lane bound when there is one."""
        vs = self.rows_per_shard(spec)
        k = min(spec.ids_per_step, vs)
        if self.max_routed_per_shard:
            k = min(k, self.max_routed_per_shard)
        if spec.arena.max_unique_per_step:
            k = min(k, spec.arena.max_unique_per_step)
        return min(max(int(spec.arena.cache_ratio * vs), k), vs)

    def shard_cache_config(
        self, spec: _CachedSlabSpec, ids_per_step: Optional[int] = None, writeback: bool = True
    ) -> cache_lib.CacheConfig:
        a = spec.arena
        ids = ids_per_step or spec.ids_per_step
        if self.max_routed_per_shard:
            ids = min(ids, self.max_routed_per_shard)
        return cache_lib.CacheConfig(
            vocab=self.rows_per_shard(spec),
            capacity=self.shard_capacity(spec),
            ids_per_step=ids,
            buffer_rows=a.buffer_rows,
            policy=a.policy,
            writeback=writeback,
            max_unique_per_step=a.max_unique_per_step,
            protect_via_inverse=a.protect_via_inverse,
            freq_half_life=a.freq_half_life,
            use_pallas_plan=a.use_pallas_plan,
            chunk_rows=a.chunk_rows,
            # an unresolved "auto" structures like the policy's no-stats pick
            arena_precision=(PrecisionPolicy().no_stats if a.arena_precision == "auto"
                             else a.arena_precision),
            arena_head_ratio=a.arena_head_ratio,
        )

    # ----- init -------------------------------------------------------------

    def init(
        self,
        seed: int,
        counts: Optional[Mapping[str, np.ndarray]] = None,
        warm: bool = True,
        device: DeviceLike = None,
        host_precision: Optional[str] = None,
        arena_precision: Optional[str] = None,
    ) -> CollectionState:
        """The sharded state, drawn chunk by chunk exactly as the unsharded
        ``init`` draws it (DEVICE tables first, then the cached slabs, the
        j-th from ``seed + j``: one logical table from one seed).  A DEVICE
        table stays whole on ``device``.  Each cached chunk is encoded by
        the slab's host codec where it was drawn and lands at its ranks'
        homes ``owner * vs + local`` of the one stacked host table (pinned
        whole on a CUDA device); pad rows hold the encoded zero row.

        ``host_precision`` / ``arena_precision`` override every cached
        slab's codecs; "auto" asks ``PrecisionPolicy`` from the counts, on
        the slab's global geometry (``S`` x the shard capacity and head)."""
        dev = resolve_device(device)
        S = self.num_shards
        slabs: Dict[str, Any] = self._init_device_slabs(seed, dev)
        j = len(slabs)
        for sname, spec in list(self.cached_slabs.items()):
            vs = self.rows_per_shard(spec)
            c = slab_counts(spec, counts)
            stats = None if c is None else freq_lib.build_freq_stats(c)
            counts_ranked = stats.counts[stats.inv_map] if stats is not None else None
            K = min(self.replicate_top_k, spec.vocab)
            assign = PlacementPlanner.assign_devices(spec.vocab, S, counts_ranked,
                                                     replicate_top_k=K)
            self.assignments[sname] = assign
            cap_s = self.shard_capacity(spec)
            head_s = min(cap_s, max(1, int(round(spec.arena.arena_head_ratio * cap_s))))
            spec, codec = self._resolve_codecs(sname, c, S * cap_s, S * head_s,
                                               host_precision, arena_precision)
            home = torch.from_numpy(assign.owner.astype(np.int64) * vs
                                    + assign.local.astype(np.int64))
            flat = HostStore.allocate({"weight": ((S * vs, spec.dim), spec.dtype)}, codec)
            pad = torch.ones((S * vs,), dtype=torch.bool)
            pad[home] = False
            pad_rows = torch.nonzero(pad).reshape(-1)
            flat.write_at(pad_rows, {"weight": torch.zeros((pad_rows.numel(), spec.dim),
                                                           dtype=spec.dtype, device=dev)})
            rep_rows = torch.empty((K, spec.dim), dtype=spec.dtype, device=dev)
            for r0, chunk in draw_chunks(seed + j, spec.vocab, spec.dim, spec.dtype, dev):
                flat.write_at(home[r0 : r0 + chunk.shape[0]], {"weight": chunk})
                if r0 < K:
                    rep_rows[r0 : r0 + chunk.shape[0]] = chunk[: K - r0]
            j += 1
            if dev.type == "cuda":
                flat.pin()
            full = _stack_store(flat, S, vs)
            ccfg = self.shard_cache_config(spec)
            cache = _stack([
                cache_lib.init_cache(ccfg, {"weight": torch.zeros((spec.dim,), dtype=spec.dtype)},
                                     dev)
                for _ in range(S)
            ])
            if warm:
                warmed = [cache_lib.warmup(ccfg, full.shard(s), _shard(cache, s))[1]
                          for s in range(S)]
                cache = _with_index(cache, warmed)
            idx_map = (torch.from_numpy(stats.idx_map) if stats is not None
                       else torch.arange(spec.vocab, dtype=torch.int32))
            slabs[sname] = ShardedSlab(
                full=full,
                cache=cache,
                idx_map=idx_map.to(dev),
                rank_owner=torch.from_numpy(assign.owner).to(dev),
                rank_local=torch.from_numpy(assign.local).to(dev),
                routed_lanes=torch.zeros((S,), dtype=torch.int32, device=dev),
                rep=RepArena(
                    rows=rep_rows,
                    score=torch.zeros((K,), dtype=torch.float32, device=dev),
                    last_touch=torch.zeros((K,), dtype=torch.int32, device=dev),
                    step=torch.zeros((), dtype=torch.int32, device=dev),
                ),
            )
        return CollectionState(slabs=slabs)

    # ----- id routing -------------------------------------------------------

    def _rank_ids(self, slab: ShardedSlab, raw: torch.Tensor) -> torch.Tensor:
        """Slab-global raw ids (-1 pad) -> frequency ranks (-1 pad)."""
        valid = raw >= 0
        return torch.where(valid, take_fill(slab.idx_map, torch.where(valid, raw, 0), -1), -1)

    def _route(self, slab: ShardedSlab, rank: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Ranks -> (owning shard, local row), -1 on padding and on the
        replicated ranks (``rank < K``), which never enter the exchange."""
        return cache_ref.route(rank, slab.rank_owner, slab.rank_local, slab.rep.rows.shape[0])

    @staticmethod
    def _dedup(rank: torch.Tensor, vocab: int, fused: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[L] ranks (-1 pad) -> ``(uniq, pos)``: the ascending unique
        buffer of ``U = min(L, vocab)`` lanes (``_PAD_RANK`` padding) and each
        lane's position in it.  ``fused`` takes the one-sort dedup of
        ``kernels/cache_ops`` (bitwise the same)."""
        u = min(int(rank.shape[0]), int(vocab))
        key = torch.where(rank >= 0, rank, _PAD_RANK)
        if fused:
            uniq, _ = cache_ops.dedup_impl(key, u, _PAD_RANK)
        else:
            uniq = cache_lib.unique_fixed(key, u, _PAD_RANK)
        pos = torch.clamp_max(torch.searchsorted(uniq, key), u - 1).to(torch.int32)
        return uniq.to(torch.int32), pos

    def _bucketize(self, owner: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
        """[U] routing -> the [S, U] per-shard local-row image (-1 off-shard)."""
        return cache_ref.bucketize(owner, local, self.num_shards)

    def _route_image(self, slab: ShardedSlab, rank: torch.Tensor, fused: bool = False
                     ) -> torch.Tensor:
        """Ranks -> the [S, U] image: ``_route`` then ``_bucketize``, or with
        ``fused`` one launch of the route + bucketize kernel on the card
        (bitwise the same)."""
        if fused:
            return cache_ops.route_image_impl(rank, slab.rank_owner, slab.rank_local,
                                              slab.rep.rows.shape[0], self.num_shards)
        return self._bucketize(*self._route(slab, rank))

    def _compact_lanes(self, owner: torch.Tensor, local: torch.Tensor, width: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Dense [S, width] image: one stable sort by owner groups each
        shard's lanes.  Returns the per-shard local rows (-1 pad), each
        compact lane's source index in the dedup'd buffer (-1 pad) and the
        per-shard count of lanes past ``width`` (the caller counts them as
        overflows)."""
        u = owner.shape[0]
        S = self.num_shards
        key = torch.where(local >= 0, owner, S)  # pad / replicated -> sentinel S
        perm = torch.argsort(key, stable=True)
        sk = key[perm]
        starts = torch.searchsorted(sk, torch.arange(S + 1, dtype=sk.dtype, device=sk.device))
        counts = i32(starts[1:] - starts[:-1])
        j = torch.arange(width, dtype=torch.int32, device=owner.device)[None, :]
        ok = j < torch.clamp_max(counts, width)[:, None]
        pos = torch.clamp(starts[:S, None] + j, 0, u - 1)
        src = torch.where(ok, perm[pos], -1).to(torch.int32)
        rows = torch.where(ok, take_fill(local, torch.where(ok, src, 0), -1), -1)
        return rows.to(torch.int32), src, torch.clamp_min(counts - width, 0)

    def _lane_width(self, u: int) -> Optional[int]:
        """The compact image's width, or None for the full-width image."""
        w = self.max_routed_per_shard
        return None if w <= 0 or w >= u else w

    def _lookup_combined(self, row_to_slot: torch.Tensor, owner: torch.Tensor,
                         local: torch.Tensor, cap: int) -> torch.Tensor:
        """Combined address of each (owner, local) lane under the stacked
        ``[S, vs]`` index image (-1 when not resident on its owner, or a
        padding / replicated lane)."""
        enc = torch.zeros(owner.shape, dtype=torch.int32, device=owner.device)
        for s in range(self.num_shards):
            slot = take_fill(row_to_slot[s], torch.where(owner == s, local, 0), -1)
            enc = enc + torch.where((owner == s) & (slot >= 0), s * cap + slot + 1, 0)
        return i32(enc - 1)

    @staticmethod
    def _combine_slots(per_shard_slots: torch.Tensor, cap: int) -> torch.Tensor:
        """[S, U] per-shard slots (-1 off-shard) -> [U] combined addresses
        ``owner * cap + slot`` (-1 pad): each lane is resident on one shard,
        so the integer sum of the shifted encodings is exact."""
        S = per_shard_slots.shape[0]
        sids = torch.arange(S, dtype=torch.int32, device=per_shard_slots.device)[:, None]
        enc = torch.where(per_shard_slots >= 0, sids * cap + per_shard_slots + 1, 0)
        return i32(enc.sum(0)) - 1

    # ----- the non-diff bookkeeping pass ------------------------------------

    def plan_prepare(
        self,
        state: CollectionState,
        fb: FeatureBatch,
        fb_future: Sequence[FeatureBatch] = (),
        writeback: bool = True,
    ) -> ShardedCollectionPlan:
        """Translate ids, dedup and route them, build the per-shard image,
        and plan each shard against its slice of the stacked state.

        A lookahead window ``fb_future`` merges into ONE dedup'd image per
        slab, routed and bucketized (or compacted) like the batch, whose
        row ``s`` is shard ``s``'s ``future_rows``.  The window's addresses
        come from the planned index images (replicated lanes always
        resident), and ``future_unresident`` sums over the shards."""
        self._check_features(fb, *fb_future)
        S = self.num_shards
        addresses, *future_addresses = self._device_addresses((fb, *fb_future))
        unresident = []
        slab_plans: Dict[str, cache_lib.CachePlan] = {}
        routed: Dict[str, torch.Tensor] = {}
        uniq_ranks: Dict[str, torch.Tensor] = {}
        for sname, spec in self.cached_slabs.items():
            raw = self._slab_raw(fb, sname)
            fut_raws = [self._slab_raw(b, sname) for b in fb_future]
            if raw is None:  # touched by the window only: not prefetched
                unresident += [(r >= 0).sum() for r in fut_raws if r is not None]
                continue
            slab = state.slabs[sname]
            cap = self.shard_capacity(spec)
            K = slab.rep.rows.shape[0]
            ncomb = S * cap  # replicated addresses live past this
            rank = self._rank_ids(slab, raw)
            fused = spec.arena.use_pallas_plan
            uniq, pos = self._dedup(rank, spec.vocab, fused=fused)
            width = self._lane_width(int(uniq.shape[0]))
            if width is None:
                rows_sh = self._route_image(slab, uniq, fused=fused)  # [S, U]
            else:
                rows_sh, src_sh, lane_over = self._compact_lanes(*self._route(slab, uniq),
                                                                 width)
            fut_ranks = [None if r is None else self._rank_ids(slab, r) for r in fut_raws]
            fut_parts = [r for r in fut_ranks if r is not None]
            fut_sh = None
            if fut_parts:  # the window's one dedup'd image
                fuq, _ = self._dedup(torch.cat(fut_parts), spec.vocab, fused=fused)
                if width is None:
                    fut_sh = self._route_image(slab, fuq, fused=fused)
                else:  # a dropped window lane loses its pin; the guard still counts it
                    fut_sh = self._compact_lanes(*self._route(slab, fuq), width)[0]
            ccfg = self.shard_cache_config(spec, ids_per_step=int(rows_sh.shape[1]),
                                           writeback=writeback)
            plan = _stack([
                cache_lib.plan_prepare(ccfg, _shard(slab.cache, s), rows_sh[s],
                                       future_rows=None if fut_sh is None else fut_sh[s])
                for s in range(S)])
            if width is not None:  # a dropped lane would gather a zero row
                plan.uniq_overflows = plan.uniq_overflows + lane_over
            slab_plans[sname] = plan
            routed[sname] = i32((rows_sh >= 0).sum(1))
            uniq_ranks[sname] = torch.where(uniq < _PAD_RANK, uniq, -1)
            if width is None:
                combined = self._combine_slots(plan.slots, cap)  # [U]
            else:  # scatter the compact slots back to dedup'd lane order
                u_n = int(uniq.shape[0])
                sids = torch.arange(S, dtype=torch.int32, device=uniq.device)[:, None]
                enc = torch.where((src_sh >= 0) & (plan.slots >= 0),
                                  sids * cap + plan.slots + 1, 0).to(torch.int32)
                dest = torch.where(src_sh >= 0, src_sh, u_n).reshape(-1).to(torch.int64)
                combined = torch.zeros((u_n + 1,), dtype=torch.int32, device=uniq.device)
                combined = combined.index_add_(0, dest, enc.reshape(-1))[:u_n] - 1
            if K:
                combined = torch.where(uniq < K, ncomb + uniq, combined)
            lane_addr = torch.where(rank >= 0, torch.index_select(combined, 0, pos), -1)
            off = 0
            for f, n in self._slab_lanes(fb, sname):
                addresses[f] = lane_addr[off : off + n].reshape(fb.ids[f].shape)
                off += n
            for j, (b, rank_j) in enumerate(zip(fb_future, fut_ranks)):
                if rank_j is None:
                    continue
                o_j, l_j = self._route(slab, rank_j)
                slots_j = self._lookup_combined(plan.row_to_slot, o_j, l_j, cap)
                if K:
                    slots_j = torch.where((rank_j >= 0) & (rank_j < K), ncomb + rank_j, slots_j)
                # a replicated lane has l_j = -1: never unresident
                unresident.append(((l_j >= 0) & (slots_j < 0)).sum())
                off = 0
                for f, n in self._slab_lanes(b, sname):
                    future_addresses[j][f] = slots_j[off : off + n].reshape(b.ids[f].shape)
                    off += n
        plan = ShardedCollectionPlan(slab_plans=slab_plans, routed=routed, addresses=addresses,
                                     uniq_ranks=uniq_ranks,
                                     future_addresses=tuple(future_addresses),
                                     writeback=writeback)
        if unresident:
            plan.future_unresident = i32(torch.stack(unresident).sum())
        return plan

    def apply_plan(self, state: CollectionState, plan: ShardedCollectionPlan
                   ) -> CollectionState:
        """Each shard's row movement between its slice of the host table and
        its arena (in place), the stacked index images installed, the
        replicated head's touches folded into its tracker, and the routed
        lanes counted."""
        slabs = dict(state.slabs)
        for sname, p in plan.slab_plans.items():
            spec = self.cached_slabs[sname]
            ccfg = self.shard_cache_config(spec, writeback=plan.writeback)
            slab = slabs[sname]
            for s in range(self.num_shards):
                cache_lib.apply_plan(ccfg, slab.full.shard(s), _shard(slab.cache, s), _shard(p, s))
            rep = slab.rep
            step = rep.step + 1  # ticks with the per-shard plan clocks
            K = rep.rows.shape[0]
            u = plan.uniq_ranks.get(sname)
            if K and u is not None:
                # the dedup'd buffer is ascending with -1 padding last, so
                # every replicated lane lies in its first K entries
                u = u[: min(K, u.shape[0])]
                m = (u >= 0) & (u < K)
                safe = torch.where(m, u, 0)
                bumped = freq_lib.decay_bump(rep.score[safe],
                                             torch.clamp(step - rep.last_touch[safe], min=0),
                                             spec.arena.freq_half_life)
                rep = RepArena(rows=rep.rows, score=scatter_drop(rep.score, u, bumped, m),
                               last_touch=scatter_drop(rep.last_touch, u, step, m), step=step)
            else:
                rep = dataclasses.replace(rep, step=step)
            slabs[sname] = dataclasses.replace(
                slab, cache=_with_index(slab.cache, p),
                routed_lanes=slab.routed_lanes + plan.routed[sname], rep=rep,
            )
        return CollectionState(slabs=slabs)

    # ----- differentiable read path -----------------------------------------

    def weights(self, state: CollectionState) -> Dict[str, torch.Tensor]:
        """The stacked ``[S, capacity, dim]`` fast tier per slab, plus one
        ``<slab>::rep`` leaf per replicated arena (none when K = 0)."""
        out = super().weights(state)
        for sname in self.cached_slabs:
            rep = state.slabs[sname].rep
            if rep.rows.shape[0]:
                out[sname + "::rep"] = rep.rows
        return out

    def gather(
        self,
        weights: Mapping[str, torch.Tensor],
        addresses: Mapping[str, torch.Tensor],
        fb: FeatureBatch,
    ) -> Dict[str, torch.Tensor]:
        """feature -> rows through the combined addresses: the routed lanes
        from the flattened ``[S * capacity, dim]`` arena (one
        ``index_select`` per slab, encoded on the wire with an
        ``exchange_codec``), the replicated lanes from ``<slab>::rep``."""
        by_slab: Dict[str, List[str]] = {}
        for f in fb.features:
            by_slab.setdefault(self.table_slab[self.feature_to_table[f]][0], []).append(f)
        out = {}
        for sname, feats in by_slab.items():
            w = weights[sname]
            if sname not in self.cached_slabs:  # a DEVICE table: row ids
                out.update(super().gather(weights, addresses,
                                          FeatureBatch(ids={f: fb.ids[f] for f in feats})))
                continue
            ncomb = w.shape[0] * w.shape[1]
            w_flat = w.reshape(ncomb, w.shape[-1])
            flat = torch.cat([addresses[f].reshape(-1) for f in feats])
            idx = torch.where(flat < ncomb, flat, -1)
            if self.exchange_codec is None:
                rows = take_fill(w_flat, idx, 0.0)
            else:
                rows = _EncodedExchange.apply(w_flat, idx, self.exchange_codec)
            rep = weights.get(sname + "::rep")
            if rep is not None:  # replicated lanes never cross the exchange
                arena = flat >= ncomb
                loc = take_fill(rep, torch.where(arena, flat - ncomb, -1), 0.0)
                rows = torch.where(arena[:, None], loc, rows)
            parts = rows.split([addresses[f].numel() for f in feats])
            for f, part in zip(feats, parts):
                out[f] = part.reshape(addresses[f].shape + (w.shape[-1],))
        return out

    def pool(self, rows, fb, combiner="sum", *, weights=None, addresses=None,
             use_pallas=False, max_bag=0):
        """As the unsharded ``pool``; the kernel route reads the flattened
        fast tier with the replicated arena appended past it."""
        if use_pallas and weights is not None:
            fused = {}
            for k, v in weights.items():
                if k.endswith("::rep"):
                    continue
                if k in self.cached_slabs:
                    v = v.reshape((-1,) + tuple(v.shape[2:]))
                    rep = weights.get(k + "::rep")
                    if rep is not None:
                        v = torch.cat([v, rep], dim=0)
                fused[k] = v
            weights = fused
        return super().pool(rows, fb, combiner, weights=weights, addresses=addresses,
                            use_pallas=use_pallas, max_bag=max_bag)

    def apply_grads(self, state: CollectionState, grads: Mapping[str, torch.Tensor], lr
                    ) -> CollectionState:
        """SGD on the stacked fast tiers (in place), then on each replicated
        arena with its lanes' summed gradient."""
        state = super().apply_grads(state, grads, lr)
        for sname in self.cached_slabs:
            g = grads.get(sname + "::rep")
            if g is not None:
                state.slabs[sname].rep.rows.sub_(lr * g)
        return state

    def flush(self, state: CollectionState) -> CollectionState:
        """Every shard writes its residents back to its slice of the host
        table; then the replicated arena, authoritative for ranks < K,
        overwrites those ranks' homes (a warm copy of a replicated home may
        still sit in some shard's arena)."""
        for sname, spec in self.cached_slabs.items():
            ccfg = self.shard_cache_config(spec)
            slab = state.slabs[sname]
            for s in range(self.num_shards):
                cache_lib.flush(ccfg, slab.full.shard(s), _shard(slab.cache, s))
            K = slab.rep.rows.shape[0]
            if K:
                vs = self.rows_per_shard(spec)
                homes = i32(slab.rank_owner[:K] * vs + slab.rank_local[:K])
                transmitter.write_rows(
                    {"weight": slab.rep.rows}, flat_store(slab.full), homes,
                    torch.ones((K,), dtype=torch.bool, device=homes.device),
                    buffer_rows=spec.arena.buffer_rows,
                )
        return CollectionState(slabs=dict(state.slabs))

    # ----- adaptive frequency refresh ---------------------------------------

    def refresh(
        self,
        state: CollectionState,
        cfg: Optional[refresh_lib.RefreshConfig] = None,
        writeback: bool = True,
    ) -> Tuple[CollectionState, refresh_lib.RefreshReport]:
        """Sharded re-ranking refresh (see ``EmbeddingCollection.refresh``).

        The permutation is planned globally from the merged per-shard
        counters, then applied as content exchanges between the swapped
        ranks' fixed ``(owner, local)`` homes; cross-shard exchanges are
        metered by ``cfg.exchange_budget`` (excess pairs defer to the next
        pass).  With ``cfg.rebalance_threshold``, a slab whose live
        imbalance exceeds it is re-homed after the swap pass.  With one
        shard the pass is bitwise the unsharded refresh."""
        cfg = cfg or refresh_lib.RefreshConfig()
        slabs = dict(state.slabs)
        report = refresh_lib.RefreshReport()
        for sname, spec in self.cached_slabs.items():
            slabs[sname], stats = refresh_lib.refresh_sharded_slab(
                self.shard_cache_config(spec, writeback=writeback), slabs[sname], cfg,
                writeback=writeback)
            if cfg.rebalance_threshold is not None:
                slabs[sname], rstats = self._maybe_rebalance(sname, spec, slabs[sname], cfg,
                                                             writeback)
                stats = {**stats, **rstats}
            report.add(sname, stats)
        return CollectionState(slabs=slabs), report

    def _maybe_rebalance(
        self,
        sname: str,
        spec: _CachedSlabSpec,
        slab: ShardedSlab,
        cfg: refresh_lib.RefreshConfig,
        writeback: bool,
    ) -> Tuple[ShardedSlab, Dict[str, Any]]:
        """Traffic-aware re-homing: the live routed imbalance (max / mean of
        the shards' decayed tracker mass, the replicated ranks counting
        none); above ``cfg.rebalance_threshold``, ``assign_devices`` on the
        live scores gives every rank a new home, the slab's rows and
        trackers move there (``refresh.apply_rebalance``), each shard's
        cache is re-warmed and the new ``rank_owner`` / ``rank_local`` are
        installed.  Pure data movement: lookups give the same values."""
        S = self.num_shards
        vs = self.rows_per_shard(spec)
        K = int(slab.rep.rows.shape[0])
        owner, local = refresh_lib.homes(slab)
        scores = refresh_lib.sharded_scores(slab, spec.arena.freq_half_life, owner, local)
        scores[:K] = 0.0  # replicated ranks carry no routed traffic
        load = np.zeros((S,), np.float64)
        np.add.at(load, owner[K:], scores[K:])
        mean = float(load.mean())
        imb = float(load.max() / mean) if mean > 0 else 1.0
        stats: Dict[str, Any] = {"rebalance_moves": 0, "rebalance_imbalance": imb}
        if imb <= float(cfg.rebalance_threshold):
            return slab, stats
        assign = PlacementPlanner.assign_devices(spec.vocab, S, scores, replicate_top_k=K)
        new_flat = assign.owner.astype(np.int64) * vs + assign.local.astype(np.int64)
        old_flat = owner * vs + local
        moved = int(np.sum(new_flat != old_flat))
        if not moved:
            return slab, stats
        src_for_dest = np.arange(S * vs, dtype=np.int64)  # new flat home -> old flat home
        src_for_dest[new_flat] = old_flat
        full, cache = refresh_lib.apply_rebalance(slab.full, slab.cache, src_for_dest,
                                                  buffer_rows=spec.arena.buffer_rows,
                                                  writeback=writeback)
        ccfg = self.shard_cache_config(spec, writeback=writeback)
        warmed = [cache_lib.warmup(ccfg, full.shard(s), _shard(cache, s))[1] for s in range(S)]
        self.assignments[sname] = assign
        stats["rebalance_moves"] = moved
        dev = slab.rank_owner.device
        return dataclasses.replace(
            slab, full=full, cache=_with_index(cache, warmed),
            rank_owner=torch.from_numpy(assign.owner).to(dev),
            rank_local=torch.from_numpy(assign.local).to(dev),
        ), stats

    # ----- oracles / bulk reads ---------------------------------------------

    def _rank_rows(self, slab: ShardedSlab, rank: torch.Tensor) -> torch.Tensor:
        """Host-table rows of ranks (-1 lanes: zero rows) on the device of
        ``rank``; replicated ranks read the arena, which is authoritative."""
        vs = slab.full["weight"].shape[1]
        ok = rank >= 0
        safe = torch.where(ok, rank, 0)
        owner = take_fill(slab.rank_owner, safe, -1)
        local = take_fill(slab.rank_local, safe, -1)
        flat = torch.where(ok & (owner >= 0), owner * vs + local, -1)
        rows = flat_store(slab.full).decode_rows(flat.cpu())["weight"].to(rank.device)
        K = slab.rep.rows.shape[0]
        if K:
            in_rep = ok & (rank < K)
            rep_rows = take_fill(slab.rep.rows, torch.where(in_rep, rank, -1), 0.0)
            rows = torch.where(in_rep[:, None], rep_rows, rows)
        return rows

    def full_lookup(self, state: CollectionState, table: str, local_ids: torch.Tensor
                    ) -> torch.Tensor:
        sname, off = self.table_slab[table]
        if sname in self.device_slabs:
            return super().full_lookup(state, table, local_ids)
        slab = state.slabs[sname]
        raw = torch.where(local_ids >= 0, local_ids + off, -1)
        return self._rank_rows(slab, self._rank_ids(slab, raw))

    def dense_reference(self, state: CollectionState, fb: FeatureBatch
                        ) -> Dict[str, torch.Tensor]:
        """Rows read straight out of the host table (and the replicated
        arena): the uncached oracle, exact after a flush or when serving."""
        out = {}
        for f in fb.features:
            ids = fb.ids[f]
            rows = self.full_lookup(state, self.feature_to_table[f], ids.reshape(-1))
            out[f] = rows.reshape(ids.shape + (rows.shape[-1],))
        return out

    # ----- telemetry / accounting -------------------------------------------

    def metrics(self, state: CollectionState, writeback: bool = True) -> Dict[str, Any]:
        """Unsharded telemetry (counters summed over shards) plus the
        exchange accounting: cumulative routed lanes per slab priced at 4 B
        of id out plus one row back (at the exchange codec's width), split
        by leg; the ``[S]`` routed-lane histogram; ``shard_imbalance``, the
        live max / mean of the shards' decayed tracker mass, and
        ``shard_imbalance_routed``, that of the cumulative routed lanes."""
        out = super().metrics(state, writeback=writeback)
        S = self.num_shards
        lanes: Dict[str, torch.Tensor] = {}
        lane_bytes: Dict[str, torch.Tensor] = {}
        id_lane_bytes: Dict[str, torch.Tensor] = {}
        row_lane_bytes: Dict[str, torch.Tensor] = {}
        id_bytes = row_bytes = 0.0
        per_shard = live = 0
        for sname, spec in self.cached_slabs.items():
            slab = state.slabs[sname]
            dev = slab.routed_lanes.device
            n = i32(slab.routed_lanes.sum())
            if self.exchange_codec:
                rb = int(get_codec(self.exchange_codec).row_bytes((spec.dim,), spec.dtype))
            else:
                rb = spec.dim * spec.dtype.itemsize
            lanes[sname] = n
            lane_bytes[sname] = torch.tensor(4 + rb, dtype=torch.int32, device=dev)
            id_lane_bytes[sname] = torch.tensor(4, dtype=torch.int32, device=dev)
            row_lane_bytes[sname] = torch.tensor(rb, dtype=torch.int32, device=dev)
            id_bytes = id_bytes + n.to(torch.float32) * 4
            row_bytes = row_bytes + n.to(torch.float32) * rb
            per_shard = per_shard + slab.routed_lanes
            tr = slab.cache.tracker
            live = live + freq_lib.decay_to(tr.score, tr.last_touch, slab.cache.step[:, None],
                                            spec.arena.freq_half_life).sum(1)
        if not self.cached_slabs:  # every table DEVICE: no exchange
            per_shard, live = torch.zeros((S,), dtype=torch.int32), torch.zeros((S,))
        tot = i32(per_shard.sum())
        mean = tot.to(torch.float32) / S
        tot_live = live.sum()
        out["exchange_routed_lanes"] = lanes
        out["exchange_lane_bytes"] = lane_bytes
        out["exchange_id_lane_bytes"] = id_lane_bytes
        out["exchange_row_lane_bytes"] = row_lane_bytes
        out["exchange_id_bytes"] = id_bytes
        out["exchange_row_bytes"] = row_bytes
        out["exchange_bytes"] = id_bytes + row_bytes
        out["exchange_per_shard_lanes"] = i32(per_shard)
        out["shard_imbalance"] = torch.where(
            tot_live > 0, live.max() / torch.clamp_min(tot_live / S, 1e-9), 1.0)
        out["shard_imbalance_routed"] = torch.where(
            tot > 0, per_shard.max().to(torch.float32) / torch.clamp_min(mean, 1e-9), 1.0)
        return out

    def device_bytes(self) -> Dict[str, Any]:
        """Footprint of the sharded layout: ``device_total`` counts the
        DEVICE tables and the routing maps once, the stacked arrays, and
        the replicated arena S times (each GPU of a multi-GPU layout holds
        a copy); ``device_per_shard`` is one GPU's share, the number the
        per-device budget bounds.  The host tier is priced at each slab's
        codec."""
        S = self.num_shards
        per_slab: Dict[str, int] = {n: t.full_bytes for n, t in self.device_slabs.items()}
        replicated = sum(per_slab.values())
        stacked = rep_arenas = 0
        slow = slow_fp32 = fast_fp32 = fast_actual = 0
        for sname, spec in self.cached_slabs.items():
            item = spec.dtype.itemsize
            vs = self.rows_per_shard(spec)
            cap = self.shard_capacity(spec)
            ccfg = self.shard_cache_config(spec)
            w = tiered_arena_bytes(cap, ccfg.head_capacity, spec.dim, spec.dtype,
                                   ccfg.arena_precision)
            fast_fp32 += S * cap * spec.dim * item
            fast_actual += S * w
            # per shard: arena, slot bookkeeping (3), row_to_slot + tracker (3)
            stack = S * (w + cap * 4 * 3 + vs * 4 * 3)
            rep = spec.vocab * 4 * 3  # idx_map, rank_owner, rank_local
            K = min(self.replicate_top_k, spec.vocab)
            rep_arena = K * (spec.dim * item + 4 + 4) + 4  # rows, score, last_touch; step
            per_slab[sname] = stack + rep + S * rep_arena
            stacked += stack
            replicated += rep
            rep_arenas += rep_arena
            slow += S * vs * get_codec(self._slab_codec(sname)).row_bytes((spec.dim,), spec.dtype)
            slow_fp32 += S * vs * spec.dim * item
        return {
            "device_total": replicated + stacked + S * rep_arenas,
            "device_per_shard": replicated + rep_arenas + stacked // S,
            "slow_tier_bytes": slow,
            "host_bytes_saved": slow_fp32 - slow,
            "arena_bytes_saved": fast_fp32 - fast_actual,
            "per_slab": per_slab,
            "budget_bytes": self.plan.budget_bytes,
        }
