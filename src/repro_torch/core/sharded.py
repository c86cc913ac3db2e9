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
  ``device_bytes()["device_per_shard"]`` prices (under a mesh a rank holds
  exactly that share).
* ``plan_prepare(fb_future=)`` merges a lookahead window per shard: one
  dedup'd image of the window, routed (a second bucketize per plan) and
  handed to each shard's plan as its ``future_rows``.

* ``refresh`` plans the re-ranking globally and exchanges row content
  between the swapped ranks' fixed homes (``core.refresh``); with
  ``rebalance_threshold`` it re-homes every rank of a slab whose live
  traffic has drifted out of balance.

Under a mesh (``create(mesh=)``, a ``dist.mesh.HybridMesh`` with ``model
== S``) each process holds one shard: shard ``s = model_rank`` of every
stacked leaf (its cache and arena, its ``[1, vs, dim]`` slice of the host
table, pinned by that rank alone), with the leading shard dim kept, and
the routing tables, the replicated head and the MLPs whole.  The
per-shard loops run over the local shards only, the plans' slots and the
gathered rows cross between the ranks of a data replica through
``dist.exchange`` (bitwise the stacked layout's), and ``metrics``
all-gathers the per-shard counters, so that a rank reports what the
stacked layout reports.  At ``data > 1`` each replica holds ``1 / data``
of the batch: ``plan_prepare`` gathers the ids over the data axis and
plans the global batch (every replica of a shard keeps the same cache),
a replica gathers rows for its own lanes, and the train step sums the
gradients over the data axis in a fixed order (the arena's at the plan's
``grad_rows`` only).  The lookahead window and the refresh and rebalance
run across the ranks.  ``shard_specs`` gives
the reference's partition spec of every leaf (``dist.partitioning``).

The budget mode runs under a mesh: every rank draws the DEVICE tables
whole from the same seeds (replicas, bitwise equal), and each cached slab
splits one shard a rank, its host codec resolved alike on every rank.
Under a split mesh a DEVICE table is read by the ordered take
(``lanes.take_fill_ordered``), so every rank steps an equal copy in
torch's default mode, and at ``data > 1`` its gradient crosses the data
axis only at the global batch's distinct ids of the table (the plan's
``grad_rows``; the whole table where its vocab is no larger than its
lanes).  ``pool``'s kernel route under a split mesh pools each slab's
gathered lanes in one ``embedding_bag_multi`` launch (:meth:`_pool_lanes`),
bitwise the stacked kernel route; at ``data > 1`` the ids cross the data
axis and the segments stay each replica's, which must feed the same
number of lanes of every feature.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis.contracts import INT_COUNTERS, METRICS_INT_COUNTERS, contract
from repro_torch.core import cache as cache_lib
from repro_torch.core import freq as freq_lib
from repro_torch.core import refresh as refresh_lib
from repro_torch.core import transmitter
from repro_torch.core.collection import (
    ArenaConfig,
    CollectionState,
    DeviceSlab,
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
from repro_torch.core.lanes import i32, scatter_drop, take_fill, take_fill_ordered
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist import exchange
from repro_torch.dist.partitioning import MODEL_AXIS, P
from repro_torch.kernels.cache_ops import ops as cache_ops
from repro_torch.kernels.cache_ops import ref as cache_ref
from repro_torch.dist.mesh import HybridMesh
from repro_torch.store.arena import ArenaStore, tiered_arena_bytes
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
    # at data > 1, for the step's batch and then each window batch: each cached
    # slab's send list of its shard's distinct rows in the global plan (local
    # arena slots, -1 a zero row), the rows its arena gradient crosses the
    # data axis at (``pick_grad_rows``); empty otherwise
    grad_rows: Tuple[Dict[str, torch.Tensor], ...] = ()


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
        mesh: Optional[HybridMesh] = None,
    ):
        super().__init__(tables, plan)
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        self.num_shards = int(num_shards)
        if mesh is not None and mesh.model != self.num_shards:
            raise ValueError(f"a collection of {num_shards} shards on a (data={mesh.data}, "
                             f"model={mesh.model}) mesh: the model axis must be the shard "
                             f"count")
        # None: all S shards stacked in this process; a mesh: shard model_rank alone
        self.mesh = mesh
        self.local_shards: Tuple[int, ...] = (
            tuple(range(self.num_shards)) if mesh is None else (mesh.model_rank,))
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
        mesh: Optional[HybridMesh] = None,
        **arena_kw,
    ) -> "ShardedEmbeddingCollection":
        """Plan and build, like ``EmbeddingCollection.create`` plus the
        shard count: without a budget the paper's single arena split over
        ``num_shards`` shards; with ``budget_bytes`` (the PER-DEVICE budget)
        or a ``planner``, its DEVICE / CACHED / GROUPED plan, the cached
        slabs sharded.  ``mesh``: this process holds one shard."""
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
                   max_routed_per_shard, mesh)

    # ----- the mesh ----------------------------------------------------------

    def _split(self) -> bool:
        """The shards live in more than one process."""
        return self.mesh is not None and self.num_shards > 1

    def _local(self, per_shard: torch.Tensor) -> torch.Tensor:
        """The local shards' entries of an ``[S, ...]`` tensor."""
        if self.mesh is None:
            return per_shard
        s = self.mesh.model_rank
        return per_shard[s : s + 1]

    def _local_pos(self, device: torch.device) -> torch.Tensor:
        """int32 ``[S]``: shard -> its index among the local shards (-1 when
        another rank holds it)."""
        pos = torch.full((self.num_shards,), -1, dtype=torch.int32)
        pos[list(self.local_shards)] = torch.arange(len(self.local_shards), dtype=torch.int32)
        return pos.to(device)

    def _all_slots(self, slots: torch.Tensor) -> torch.Tensor:
        """The local plans' ``[L, U]`` slots -> every shard's ``[S, U]``."""
        return slots if self.mesh is None else exchange.slot_leg(slots, self.mesh)

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
        the slab's global geometry (``S`` x the shard capacity and head).

        Under a mesh every chunk is drawn as above, and only the homes of
        this rank's shard land in its ``[1, vs, dim]`` host slice: the
        rank's state is shard ``model_rank`` of the stacked state, bitwise,
        and no rank builds the whole table."""
        dev = resolve_device(device)
        S = self.num_shards
        L = len(self.local_shards)
        pos = self._local_pos(torch.device("cpu")).numpy().astype(np.int64)
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
            # each rank's home in this process's [L * vs] table (-1: another rank's)
            lpos = pos[assign.owner]
            home = torch.from_numpy(np.where(lpos >= 0, lpos * vs + assign.local.astype(np.int64),
                                             -1))
            flat = HostStore.allocate({"weight": ((L * vs, spec.dim), spec.dtype)}, codec)
            pad = torch.ones((L * vs,), dtype=torch.bool)
            pad[home[home >= 0]] = False
            pad_rows = torch.nonzero(pad).reshape(-1)
            flat.write_at(pad_rows, {"weight": torch.zeros((pad_rows.numel(), spec.dim),
                                                           dtype=spec.dtype, device=dev)})
            rep_rows = torch.empty((K, spec.dim), dtype=spec.dtype, device=dev)
            for r0, chunk in draw_chunks(seed + j, spec.vocab, spec.dim, spec.dtype, dev):
                h = home[r0 : r0 + chunk.shape[0]]
                if L == S:
                    flat.write_at(h, {"weight": chunk})
                else:  # this rank's homes only
                    mine = h >= 0
                    flat.write_at(h[mine], {"weight": chunk[mine.to(dev)]})
                if r0 < K:
                    rep_rows[r0 : r0 + chunk.shape[0]] = chunk[: K - r0]
            j += 1
            if dev.type == "cuda":
                flat.pin()
            full = _stack_store(flat, L, vs)
            ccfg = self.shard_cache_config(spec)
            cache = _stack([
                cache_lib.init_cache(ccfg, {"weight": torch.zeros((spec.dim,), dtype=spec.dtype)},
                                     dev)
                for _ in range(L)
            ])
            if warm:
                warmed = [cache_lib.warmup(ccfg, full.shard(i), _shard(cache, i))[1]
                          for i in range(L)]
                cache = _with_index(cache, warmed)
            idx_map = (torch.from_numpy(stats.idx_map) if stats is not None
                       else torch.arange(spec.vocab, dtype=torch.int32))
            slabs[sname] = ShardedSlab(
                full=full,
                cache=cache,
                idx_map=idx_map.to(dev),
                rank_owner=torch.from_numpy(assign.owner).to(dev),
                rank_local=torch.from_numpy(assign.local).to(dev),
                routed_lanes=torch.zeros((L,), dtype=torch.int32, device=dev),
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

    def _route_lanes(self, slab: ShardedSlab, rank: torch.Tensor, fused: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``_route`` of the dedup'd ranks, or with ``fused`` the route from
        one launch of the route + bucketize kernel on the card (bitwise the
        same; the compact image leaves its ``[S, U]`` image unread)."""
        if fused:
            return cache_ops.route_bucketize_impl(rank, slab.rank_owner, slab.rank_local,
                                                  slab.rep.rows.shape[0], self.num_shards)[:2]
        return self._route(slab, rank)

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
        """Combined address of each (owner, local) lane under the local
        shards' ``[L, vs]`` index images (-1 when not resident on its owner,
        or a padding / replicated lane); under a split mesh each lane's
        address comes from its owner's rank."""
        enc = torch.zeros(owner.shape, dtype=torch.int32, device=owner.device)
        for i, s in enumerate(self.local_shards):
            slot = take_fill(row_to_slot[i], torch.where(owner == s, local, 0), -1)
            enc = enc + torch.where((owner == s) & (slot >= 0), s * cap + slot + 1, 0)
        out = i32(enc - 1)
        if self._split():
            out = exchange.owner_rows(out, torch.where(owner >= 0, owner, 0), self.mesh)
        return out

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

    @contract(max_sort_size=64, int_counters=INT_COUNTERS)
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
        resident), and ``future_unresident`` sums over the shards.

        Under a mesh every rank routes its replica's whole batch (the image
        is replicated), plans its own shard, and the slot leg gathers every
        shard's slots for the combined addresses; a window lane's address
        comes from its owner's index image.  At ``data > 1`` the batch and
        the window are first gathered over the data axis into the global
        batch (one collective), planned exactly as at ``data == 1``, and
        the addresses returned are this replica's slice of the global ones;
        ``grad_rows`` holds each batch's gradient rows.
        Under a mesh at a compact width, a window lane past its shard's
        ``W`` distinct rows (which the row leg would drop) counts as
        unresident."""
        self._check_features(fb, *fb_future)
        S = self.num_shards
        batches = self._global_batches((fb, *fb_future))
        fb, fb_future = batches[0], batches[1:]
        addresses, *future_addresses = self._device_addresses(batches)
        grad_rows: List[Dict[str, torch.Tensor]] = [
            self._device_grad_rows(b) if self._data_split() else {} for b in batches]
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
                rows_sh, src_sh, lane_over = self._compact_lanes(
                    *self._route_lanes(slab, uniq, fused=fused), width)
            fut_ranks = [None if r is None else self._rank_ids(slab, r) for r in fut_raws]
            fut_parts = [r for r in fut_ranks if r is not None]
            fut_sh = None
            if fut_parts:  # the window's one dedup'd image
                fuq, _ = self._dedup(torch.cat(fut_parts), spec.vocab, fused=fused)
                if width is None:
                    fut_sh = self._route_image(slab, fuq, fused=fused)
                else:  # a dropped window lane loses its pin; the guard still counts it
                    fut_sh = self._compact_lanes(*self._route_lanes(slab, fuq, fused=fused),
                                                 width)[0]
            ccfg = self.shard_cache_config(spec, ids_per_step=int(rows_sh.shape[1]),
                                           writeback=writeback)
            plan = _stack([
                cache_lib.plan_prepare(ccfg, _shard(slab.cache, i), rows_sh[s],
                                       future_rows=None if fut_sh is None else fut_sh[s])
                for i, s in enumerate(self.local_shards)])
            if width is not None:  # a dropped lane would gather a zero row
                plan.uniq_overflows = plan.uniq_overflows + self._local(lane_over)
            slab_plans[sname] = plan
            routed[sname] = i32((rows_sh >= 0).sum(1))
            uniq_ranks[sname] = torch.where(uniq < _PAD_RANK, uniq, -1)
            slots = self._all_slots(plan.slots)  # [S, U] (or [S, W])
            if width is None:
                combined = self._combine_slots(slots, cap)  # [U]
            else:  # scatter the compact slots back to dedup'd lane order
                u_n = int(uniq.shape[0])
                sids = torch.arange(S, dtype=torch.int32, device=uniq.device)[:, None]
                enc = torch.where((src_sh >= 0) & (slots >= 0),
                                  sids * cap + slots + 1, 0).to(torch.int32)
                dest = torch.where(src_sh >= 0, src_sh, u_n).reshape(-1).to(torch.int64)
                combined = torch.zeros((u_n + 1,), dtype=torch.int32, device=uniq.device)
                combined = combined.index_add_(0, dest, enc.reshape(-1))[:u_n] - 1
            if K:
                combined = torch.where(uniq < K, ncomb + uniq, combined)
            lane_addr = torch.where(rank >= 0, torch.index_select(combined, 0, pos), -1)
            self._scatter_lanes(addresses, grad_rows[0], fb, sname, lane_addr, cap)
            for j, (b, rank_j) in enumerate(zip(fb_future, fut_ranks)):
                if rank_j is None:
                    continue
                o_j, l_j = self._route(slab, rank_j)
                slots_j = self._lookup_combined(plan.row_to_slot, o_j, l_j, cap)
                if K:
                    slots_j = torch.where((rank_j >= 0) & (rank_j < K), ncomb + rank_j, slots_j)
                # a replicated lane has l_j = -1: never unresident
                unresident.append(((l_j >= 0) & (slots_j < 0)).sum())
                dropped = self._scatter_lanes(future_addresses[j], grad_rows[j + 1], b, sname,
                                              slots_j, cap, window=True)
                if dropped is not None:
                    unresident.append(dropped)
        if self._data_split():
            addresses, *future_addresses = [{f: self.mesh.data_slice(a) for f, a in addr.items()}
                                             for addr in (addresses, *future_addresses)]
        plan = ShardedCollectionPlan(slab_plans=slab_plans, routed=routed, addresses=addresses,
                                     uniq_ranks=uniq_ranks,
                                     future_addresses=tuple(future_addresses),
                                     grad_rows=tuple(grad_rows) if self._data_split() else (),
                                     writeback=writeback)
        if unresident:
            plan.future_unresident = i32(torch.stack(unresident).sum())
        return plan

    def _scatter_lanes(self, addresses: Dict[str, torch.Tensor], grad_rows: Dict[str, torch.Tensor],
                       fb: FeatureBatch, sname: str, lane_addr: torch.Tensor, cap: int,
                       window: bool = False) -> Optional[torch.Tensor]:
        """A slab's flat lane addresses into ``addresses`` by feature.  At
        ``data > 1``, and for a window batch under a split mesh at a compact
        width, the exchange's send list of the lanes
        (:func:`exchange.compact_route`): its rows are the ones the shard's
        arena gradient crosses the data axis at (``grad_rows``); returns the
        live lanes past a shard's width (which the row leg would drop), or
        None where nothing is computed."""
        off = 0
        for f, n in self._slab_lanes(fb, sname):
            addresses[f] = lane_addr[off : off + n].reshape(fb.ids[f].shape)
            off += n
        W = self.max_routed_per_shard
        if not self._data_split() and not (window and W and self._split()):
            return None
        n = int(lane_addr.shape[0])
        ncomb = self.num_shards * cap
        idx = torch.where(lane_addr < ncomb, lane_addr, -1)
        width = W if 0 < W < n else min(cap, n)
        send, pick = exchange.compact_route(idx, cap, width, self.mesh)
        grad_rows[sname] = send
        return i32(((idx >= 0) & (pick == width)).sum())

    # ----- the data axis ------------------------------------------------------

    def _data_split(self) -> bool:
        """The batch is split over more than one data replica."""
        return self.mesh is not None and self.mesh.data > 1

    def _global_batches(self, fbs: Sequence[FeatureBatch]) -> List[FeatureBatch]:
        """At ``data > 1``: each replica's feature batches gathered over the
        data axis, in data-rank order, into the global batches (one
        collective for all of them); else ``fbs``."""
        fbs = list(fbs)
        if not self._data_split():
            return fbs
        if any(b.segments for b in fbs):
            self._check_lanes(fbs)
        parts = [b.ids[f].reshape(-1).to(torch.int32) for b in fbs for f in b.features]
        g = exchange.data_all_gather(torch.cat(parts), self.mesh, "ids")  # [D, N]
        D, off, out = self.mesh.data, 0, []
        for b in fbs:
            ids = {}
            for f in b.features:
                t = b.ids[f]
                ids[f] = g[:, off : off + t.numel()].reshape((D * t.shape[0],) + tuple(t.shape[1:]))
                off += t.numel()
            out.append(FeatureBatch(ids=ids))
        return out

    def _check_lanes(self, fbs: Sequence[FeatureBatch]) -> None:
        """Bag batches at ``data > 1``: every replica must feed the same
        number of lanes of each feature (the ids cross the data axis in
        one all-gather of equal parts).  The lane counts cross first, in a
        small collective of their own; refuses, naming the feature, on
        every rank alike."""
        names = [f for b in fbs for f in b.features]
        n = torch.tensor([b.ids[f].numel() for b in fbs for f in b.features], dtype=torch.int64)
        if self.mesh.backend == "nccl":  # NCCL moves card tensors only
            n = n.to(fbs[0].ids[names[0]].device)
        g = exchange.data_all_gather(n, self.mesh, "lanes").cpu()  # [D, F]
        bad = {f: c.tolist() for f, c in zip(names, g.unbind(1)) if bool((c != c[0]).any())}
        if bad:
            raise ValueError(f"the {self.mesh.data} data replicas feed different lane counts of "
                             f"feature(s) {sorted(bad)} (by replica: {bad}); each must feed the "
                             f"same number of lanes of a feature")

    def _device_grad_rows(self, fb: FeatureBatch) -> Dict[str, torch.Tensor]:
        """At ``data > 1``: each DEVICE table's distinct ids in the global
        batch ``fb`` (ascending, -1 padding to the table's lanes), the rows
        its gradient crosses the data axis at (no other row of a replica's
        gradient is nonzero); none for a table no larger than its lanes,
        whose whole gradient crosses.  One sort a table, no host sync."""
        by_table: Dict[str, List[torch.Tensor]] = {}
        for f in fb.features:
            t = self.feature_to_table[f]
            if t in self.device_slabs:
                by_table.setdefault(t, []).append(fb.ids[f].reshape(-1))
        out = {}
        for t, parts in by_table.items():
            ids = torch.cat(parts).to(torch.int32)
            vocab = self.device_slabs[t].vocab
            if vocab <= ids.shape[0]:
                continue
            key = torch.where((ids >= 0) & (ids < vocab), ids, _PAD_RANK)
            uniq, _ = cache_ops.dedup_impl(key, int(ids.shape[0]), _PAD_RANK)
            out[t] = torch.where(uniq < _PAD_RANK, uniq, -1)
        return out

    def pick_grad_rows(self, grads: Mapping[str, torch.Tensor],
                       grad_rows: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The part of each weight gradient that crosses the data axis: a
        cached slab's ``[1, capacity, dim]`` arena gradient at its shard's
        distinct rows of the global plan and a DEVICE table's at the
        global batch's distinct ids (``grad_rows``, a plan's); any other
        weight's whole (a DEVICE table no larger than its lanes, the
        replicated head)."""
        out = {}
        for k, g in grads.items():
            if k in grad_rows:
                g = take_fill(g[0] if k in self.cached_slabs else g, grad_rows[k], 0.0)
            out[k] = g
        return out

    def place_grad_rows(self, grads: Mapping[str, torch.Tensor], parts: Mapping[str, torch.Tensor],
                        grad_rows: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Inverse of :meth:`pick_grad_rows` on the parts after the data
        axis: an arena's or a DEVICE table's rows scattered back into a
        zero gradient of its shape (the rows are distinct; a -1 entry's
        zero row is dropped)."""
        out = {}
        for k, x in parts.items():
            if k in grad_rows:
                arena = k in self.cached_slabs
                g = grads[k][0] if arena else grads[k]
                n = g.shape[0]
                at = torch.where(grad_rows[k] >= 0, grad_rows[k], n).to(torch.int64)
                full = g.new_zeros((n + 1,) + tuple(g.shape[1:]))
                full.index_copy_(0, at, x)
                x = full[:n].unsqueeze(0) if arena else full[:n]
            out[k] = x
        return out

    @contract(in_place=("state",), int_counters=INT_COUNTERS, max_sort_size=0, allowed_syncs=6)
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
            for i in range(len(self.local_shards)):
                cache_lib.apply_plan(ccfg, slab.full.shard(i), _shard(slab.cache, i), _shard(p, i))
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
                routed_lanes=slab.routed_lanes + self._local(plan.routed[sname]), rep=rep,
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

    @contract(max_sort_size=0)
    def gather(
        self,
        weights: Mapping[str, torch.Tensor],
        addresses: Mapping[str, torch.Tensor],
        fb: FeatureBatch,
    ) -> Dict[str, torch.Tensor]:
        """feature -> rows through the combined addresses: the routed lanes
        from the flattened ``[S * capacity, dim]`` arena (one
        ``index_select`` per slab, encoded on the wire with an
        ``exchange_codec``; under a mesh, ``exchange.row_leg`` from the
        owners' arenas), the replicated lanes from ``<slab>::rep``."""
        by_slab: Dict[str, List[str]] = {}
        for f in fb.features:
            by_slab.setdefault(self.table_slab[self.feature_to_table[f]][0], []).append(f)
        out = {}
        for sname, feats in by_slab.items():
            w = weights[sname]
            flat = torch.cat([addresses[f].reshape(-1) for f in feats])
            parts = [addresses[f].numel() for f in feats]
            if sname not in self.cached_slabs:  # a DEVICE table: row ids
                # under a split mesh every rank steps its own copy: its
                # gradient sums a row's lanes in a fixed order
                take = take_fill_ordered if self._split() else take_fill
                for f, part in zip(feats, take(w, flat, 0.0).split(parts)):
                    out[f] = part.reshape(addresses[f].shape + (w.shape[-1],))
                continue
            cap = w.shape[1]
            ncomb = self.num_shards * cap
            w_flat = w.reshape(-1, w.shape[-1])
            idx = torch.where(flat < ncomb, flat, -1)
            if self.mesh is not None:  # the row leg between the ranks
                rows = exchange.row_leg(w_flat, idx, self.mesh.model_rank * cap,
                                        self.max_routed_per_shard, self.exchange_codec,
                                        self.mesh)
            elif self.exchange_codec is None:
                rows = take_fill(w_flat, idx, 0.0)
            else:
                rows = _EncodedExchange.apply(w_flat, idx, self.exchange_codec)
            rep = weights.get(sname + "::rep")
            if rep is not None:  # replicated lanes never cross the exchange
                arena = flat >= ncomb
                # every rank steps its own copy of the head: its gradient sums in a fixed order
                loc = take_fill_ordered(rep, torch.where(arena, flat - ncomb, -1), 0.0)
                rows = torch.where(arena[:, None], loc, rows)
            for f, part in zip(feats, rows.split(parts)):
                out[f] = part.reshape(addresses[f].shape + (w.shape[-1],))
        return out

    def pool(self, rows, fb, combiner="sum", *, weights=None, addresses=None,
             use_pallas=False, max_bag=0):
        """As the unsharded ``pool``; the kernel route reads the flattened
        fast tier with the replicated arena appended past it.  Under a
        split mesh the kernel route pools each slab's gathered lanes
        (:meth:`_pool_lanes`): this rank holds one shard of the arena.
        ``fb`` is this replica's batch (its segments its own), and
        ``addresses`` its slice of the plan's."""
        if use_pallas and weights is not None and addresses is not None and self._split():
            return self._pool_lanes(rows, fb, combiner, weights, addresses, max_bag)
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

    def _pool_lanes(self, rows, fb, combiner, weights, addresses, max_bag):
        """The kernel route under a split mesh: each slab's bag lanes read
        as :meth:`gather` reads them (a cached slab's through the row leg,
        the replicated head overlaid; a DEVICE table's by the ordered
        take) into one ``[lanes, dim]`` tensor, then one
        ``embedding_bag_multi`` launch a slab over it, its ids the lane
        positions (-1 where the address is -1).  The kernel sums each
        bag's rows in bag order off the same values, so the pooled rows
        are bitwise the stacked kernel route's.  In the backward every lane
        has its own index (the kernel's ``index_add_`` is exact); a row's
        duplicate lanes are summed by the row leg's backward on the owner
        or by the ordered take's."""
        from repro_torch.kernels.embedding_bag import ops as eb_ops

        out = dict(rows)
        lanes = self.gather(weights, addresses, FeatureBatch(ids={f: fb.ids[f]
                                                                  for f in fb.segments}))
        by_slab: Dict[str, List[str]] = {}
        for f in fb.segments:
            by_slab.setdefault(self.table_slab[self.feature_to_table[f]][0], []).append(f)
        pooled = {}
        for feats in by_slab.values():
            table = torch.cat([lanes[f].reshape(-1, lanes[f].shape[-1]) for f in feats])
            addr = torch.cat([addresses[f].reshape(-1) for f in feats])
            pos = torch.arange(addr.shape[0], dtype=torch.int32, device=addr.device)
            offsets = [0]
            for f in feats:
                offsets.append(offsets[-1] + addresses[f].numel())
            stacked = eb_ops.embedding_bag_multi(
                table, torch.where(addr >= 0, pos, -1), torch.cat([fb.segments[f] for f in feats]),
                offsets, fb.num_segments, combiner=combiner, max_bag=max_bag)
            pooled.update(zip(feats, torch.unbind(stacked)))
        for f in fb.segments:  # in the batch's feature order
            out[f] = pooled[f]
        return out

    @contract(in_place=("state",), int_counters=INT_COUNTERS, max_sort_size=0)
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
            for i in range(len(self.local_shards)):
                cache_lib.flush(ccfg, slab.full.shard(i), _shard(slab.cache, i))
            K = slab.rep.rows.shape[0]
            if K:  # the replicated homes on this process's shards
                vs = self.rows_per_shard(spec)
                lpos = self._local_pos(slab.rank_owner.device)[slab.rank_owner[:K].long()]
                mine = lpos >= 0
                homes = i32(torch.where(mine, lpos * vs + slab.rank_local[:K], -1))
                transmitter.write_rows(
                    {"weight": slab.rep.rows}, flat_store(slab.full), homes, mine,
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
        shard the pass is bitwise the unsharded refresh.

        Under a mesh the trackers cross the model group, every rank plans
        the same permutation and the rows move between the ranks
        (``core.refresh``): each rank's state stays its shard of the
        stacked layout's, and the data replicas of a shard, which hold
        equal trackers, make equal passes."""
        cfg = cfg or refresh_lib.RefreshConfig()
        slabs = dict(state.slabs)
        report = refresh_lib.RefreshReport()
        for sname, spec in self.cached_slabs.items():
            slabs[sname], stats = refresh_lib.refresh_sharded_slab(
                self.shard_cache_config(spec, writeback=writeback), slabs[sname], cfg,
                writeback=writeback, mesh=self.mesh)
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
        installed.  Pure data movement: lookups give the same values.
        Under a mesh every rank reads the gathered trackers and makes the
        same assignment; the rows cross between the ranks."""
        S = self.num_shards
        vs = self.rows_per_shard(spec)
        K = int(slab.rep.rows.shape[0])
        owner, local = refresh_lib.homes(slab)
        scores = refresh_lib.sharded_scores(slab, spec.arena.freq_half_life, owner, local,
                                            self.mesh)
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
                                                  writeback=writeback, mesh=self.mesh)
        ccfg = self.shard_cache_config(spec, writeback=writeback)
        warmed = [cache_lib.warmup(ccfg, full.shard(i), _shard(cache, i))[1]
                  for i in range(len(self.local_shards))]
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
        if self.mesh is None:
            flat = torch.where(ok & (owner >= 0), owner * vs + local, -1)
            rows = flat_store(slab.full).decode_rows(flat.cpu())["weight"].to(rank.device)
        else:  # each owner's host row, through the row leg's transport
            lpos = take_fill(self._local_pos(owner.device), owner, -1)
            flat = torch.where(ok & (lpos >= 0), lpos * vs + local, -1)
            part = flat_store(slab.full).decode_rows(flat.cpu())["weight"].to(rank.device)
            rows = exchange.owner_rows(part, torch.where(owner >= 0, owner, 0), self.mesh)
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

    @contract(int_counters=METRICS_INT_COUNTERS, max_sort_size=0)
    def metrics(self, state: CollectionState, writeback: bool = True) -> Dict[str, Any]:
        """Unsharded telemetry (counters summed over shards) plus the
        exchange accounting: cumulative routed lanes per slab priced at 4 B
        of id out plus one row back (at the exchange codec's width), split
        by leg; the ``[S]`` routed-lane histogram; ``shard_imbalance``, the
        live max / mean of the shards' decayed tracker mass, and
        ``shard_imbalance_routed``, that of the cumulative routed lanes.

        Under a mesh the per-shard counters are all-gathered first (one
        collective a slab), so every rank reports the stacked layout's
        numbers."""
        live_by: Dict[str, torch.Tensor] = {}
        if self.mesh is not None:
            state, live_by = self._gathered_counters(state)
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
            lane_bytes[sname] = torch.full((), 4 + rb, dtype=torch.int32, device=dev)
            id_lane_bytes[sname] = torch.full((), 4, dtype=torch.int32, device=dev)
            row_lane_bytes[sname] = torch.full((), rb, dtype=torch.int32, device=dev)
            id_bytes = id_bytes + n.to(torch.float32) * 4
            row_bytes = row_bytes + n.to(torch.float32) * rb
            per_shard = per_shard + slab.routed_lanes
            live = live + (live_by[sname] if sname in live_by
                           else self._live_mass(slab, spec.arena.freq_half_life))
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

    @staticmethod
    def _live_mass(slab: ShardedSlab, half_life: int) -> torch.Tensor:
        """float32 ``[L]``: each local shard's decayed tracker mass now."""
        tr = slab.cache.tracker
        return freq_lib.decay_to(tr.score, tr.last_touch, slab.cache.step[:, None],
                                 half_life).sum(1)

    # the per-shard counters ``metrics`` reads (cache, tracker), in one int32 row
    _COUNTERS = ("hits", "misses", "evictions", "uniq_overflows", "tier_promotions",
                 "tier_demotions")
    _TRACKER_COUNTERS = ("refresh_swaps", "refresh_rows")
    _TRACKER_FLOATS = ("win_hits", "win_misses")

    def _gathered_counters(self, state: CollectionState
                           ) -> Tuple[CollectionState, Dict[str, torch.Tensor]]:
        """Under a mesh: ``state`` with every per-shard counter that
        ``metrics`` reads all-gathered to ``[S]`` (the float ones as their
        bits), and each slab's ``[S]`` live tracker mass."""
        slabs = dict(state.slabs)
        live_by = {}
        for sname, spec in self.cached_slabs.items():
            slab = slabs[sname]
            c, tr = slab.cache, slab.cache.tracker
            floats = [getattr(tr, k) for k in self._TRACKER_FLOATS]
            floats.append(self._live_mass(slab, spec.arena.freq_half_life))
            row = torch.cat([*(getattr(c, k) for k in self._COUNTERS),
                             *(getattr(tr, k) for k in self._TRACKER_COUNTERS),
                             slab.routed_lanes,
                             *(f.to(torch.float32).view(torch.int32) for f in floats)])
            g = exchange.all_gather(row, self.mesh, "counters")  # [S, 12]
            cols = dict(zip(self._COUNTERS + self._TRACKER_COUNTERS + ("routed_lanes",)
                            + self._TRACKER_FLOATS + ("live",), g.unbind(1)))
            for k in self._TRACKER_FLOATS + ("live",):
                cols[k] = cols[k].contiguous().view(torch.float32)
            tracker = dataclasses.replace(tr, **{k: cols[k] for k in self._TRACKER_COUNTERS
                                                 + self._TRACKER_FLOATS})
            cache = dataclasses.replace(c, tracker=tracker,
                                        **{k: cols[k] for k in self._COUNTERS})
            slabs[sname] = dataclasses.replace(slab, cache=cache, routed_lanes=cols["routed_lanes"])
            live_by[sname] = cols["live"]
        return CollectionState(slabs=slabs), live_by

    def device_bytes(self) -> Dict[str, Any]:
        """Footprint of the sharded layout: ``device_total`` counts the
        DEVICE tables and the routing maps once, the stacked arrays, and
        the replicated arena S times (each GPU of a multi-GPU layout holds
        a copy); ``device_per_shard`` is one GPU's share, the number the
        per-device budget bounds, and ``device_process`` what this process
        holds (the stacked total, or one shard's share under a mesh).  The
        host tier is priced at each slab's codec; ``host_process_bytes`` is
        this process's slice of it."""
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
        total = replicated + stacked + S * rep_arenas
        per_shard = replicated + rep_arenas + stacked // S
        return {
            "device_total": total,
            "device_per_shard": per_shard,
            "device_process": total if self.mesh is None else per_shard,
            "host_process_bytes": slow if self.mesh is None else slow // S,
            "slow_tier_bytes": slow,
            "host_bytes_saved": slow_fp32 - slow,
            "arena_bytes_saved": fast_fp32 - fast_actual,
            "per_slab": per_slab,
            "budget_bytes": self.plan.budget_bytes,
        }

    # ----- sharding ---------------------------------------------------------

    def shard_specs(self) -> CollectionState:
        """The partition spec of every leaf of the state (port of the
        reference's ``shard_specs``): each stacked leaf splits its leading
        shard dim over the ``model`` axis, the routing maps, the replicated
        head and the DEVICE tables replicate.  Call after ``init`` (the
        resolved codecs shape the tiers)."""
        ax = MODEL_AXIS
        row = P(ax, None, None)
        slabs: Dict[str, Any] = {n: DeviceSlab(weight=P(None, None)) for n in self.device_slabs}
        for sname, spec in self.cached_slabs.items():
            dt = str(spec.dtype).removeprefix("torch.")
            arena = self._slab_arena_codec(sname)
            if arena == "fp32":
                cached_rows: Any = {"weight": row}
            else:  # a tiered arena: every tier carries the shard dim, sideband included
                side = {"weight": row} if get_codec(arena).sideband_row_shape() else {}
                cached_rows = ArenaStore(head={"weight": row}, tail={"weight": row},
                                         sideband=side, raw={}, codec=arena, out_dtype=dt)
            host = self._slab_codec(sname)
            hside = {"weight": row} if get_codec(host).sideband_row_shape() else {}
            slabs[sname] = ShardedSlab(
                full=HostStore(data={"weight": row}, sideband=hside, codec=host, out_dtype=dt),
                cache=cache_lib.CacheState(
                    cached_rows=cached_rows,
                    slot_to_row=P(ax, None), row_to_slot=P(ax, None),
                    last_used=P(ax, None), use_count=P(ax, None),
                    step=P(ax), hits=P(ax), misses=P(ax), evictions=P(ax),
                    uniq_overflows=P(ax), tier_promotions=P(ax), tier_demotions=P(ax),
                    tracker=freq_lib.FreqTracker(
                        score=P(ax, None), last_touch=P(ax, None), win_hits=P(ax),
                        win_misses=P(ax), refresh_swaps=P(ax), refresh_rows=P(ax)),
                ),
                idx_map=P(None), rank_owner=P(None), rank_local=P(None),
                routed_lanes=P(ax),
                rep=RepArena(rows=P(None, None), score=P(None), last_touch=P(None), step=P()),
            )
        return CollectionState(slabs=slabs)
