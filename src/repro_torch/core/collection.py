"""Keyed-feature embeddings over the frequency-aware cache: the single-arena
subset of ``repro.core.collection``.

The paper manages ONE concatenated, frequency-ordered table through one
software cache.  The port has exactly that layout (every table GROUPED into
the shared arena, ``PlacementPlan.single_arena``) with its serving and
training surface: ``init`` / ``plan_prepare`` / ``apply_plan`` /
``prepare`` / ``weights`` / ``gather`` / ``pool`` / ``lookup`` /
``apply_grads`` / ``flush`` / ``metrics`` / ``device_bytes``.  The arena is fp32, or
frequency-tiered (``arena_precision`` fp16 / int8: an fp32 head over the
hottest slots, an encoded tail).  DEVICE and CACHED placements, the
planner, lookahead and refresh come with later slices.

On a CUDA device the host tier (``CachedSlab.full``) is a pinned
:class:`HostStore` in host memory; the arena, the index maps and
``idx_map`` live on the card.
"""
from __future__ import annotations

import dataclasses
import enum
import heapq
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import cache as cache_lib
from repro_torch.core import freq as freq_lib
from repro_torch.core.lanes import i32, segment_sum, take_fill
from repro_torch.core.policies import Policy
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.store.arena import ArenaStore, tiered_arena_bytes
from repro_torch.store.host_store import HostStore

__all__ = [
    "Placement",
    "TableConfig",
    "FeatureBatch",
    "TablePlacement",
    "ArenaConfig",
    "PlacementPlan",
    "PlacementPlanner",
    "ShardAssignment",
    "EmbeddingCollection",
    "CachedSlab",
    "CollectionState",
    "CollectionPlan",
    "cached_slab_flush",
]

SHARED_ARENA = "__shared__"
_INIT_CHUNK_ROWS = 1 << 20  # host-table init: rows drawn per device chunk


class Placement(enum.Enum):
    """This slice has the paper's placement only; DEVICE and CACHED tables
    come with the planner in a later slice."""

    GROUPED = "grouped"  # shares the collection-wide cache arena (the paper)


@dataclasses.dataclass(frozen=True)
class TableConfig:
    """One logical embedding table.  In the shared arena the cache knobs,
    ``arena_precision`` among them, are the arena's (``ArenaConfig``)."""

    name: str
    vocab: int
    dim: int
    ids_per_step: int
    feature_names: Tuple[str, ...] = ()
    dtype: torch.dtype = torch.float32

    @property
    def features(self) -> Tuple[str, ...]:
        return self.feature_names or (self.name,)


@dataclasses.dataclass
class FeatureBatch:
    """Keyed feature ids: name -> int32 id tensor (any shape, -1 = padding).

    For pooled ("bag") features, ``segments[name]`` assigns each flat lane to
    an output row (``num_segments`` rows in all); ``EmbeddingCollection.pool``
    runs the segment reduction after the cached gather."""

    ids: Dict[str, torch.Tensor]
    segments: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    num_segments: int = 0

    @classmethod
    def from_onehot(cls, names: Sequence[str], id_matrix: torch.Tensor) -> "FeatureBatch":
        """Criteo-style [batch, fields] matrix -> one [batch] feature per name."""
        if id_matrix.dim() != 2 or id_matrix.shape[1] != len(names):
            raise ValueError(f"want a [batch, {len(names)}] id matrix, got {tuple(id_matrix.shape)}")
        return cls(ids={n: id_matrix[:, j].to(torch.int32) for j, n in enumerate(names)})

    @classmethod
    def from_bags(
        cls,
        bags: Mapping[str, Tuple[torch.Tensor, torch.Tensor]],
        num_segments: int,
        extra_onehot: Optional[Mapping[str, torch.Tensor]] = None,
    ) -> "FeatureBatch":
        """Ragged multi-hot bags: name -> (flat_ids, segment_ids)."""
        ids = {n: flat.to(torch.int32) for n, (flat, _) in bags.items()}
        segments = {n: seg.to(torch.int32) for n, (_, seg) in bags.items()}
        if extra_onehot:
            ids.update({n: v.to(torch.int32) for n, v in extra_onehot.items()})
        return cls(ids=ids, segments=segments, num_segments=num_segments)

    @property
    def features(self) -> Tuple[str, ...]:
        return tuple(self.ids)


@dataclasses.dataclass(frozen=True)
class TablePlacement:
    placement: Placement


@dataclasses.dataclass(frozen=True)
class ArenaConfig:
    """Knobs of the shared GROUPED cache arena."""

    cache_ratio: float = 0.015
    policy: Policy = Policy.FREQ_LFU
    buffer_rows: int = 65536
    max_unique_per_step: int = 0
    protect_via_inverse: bool = True
    freq_half_life: int = 1024
    use_pallas_plan: bool = False
    arena_precision: str = "fp32"  # the arena's device-tail codec (fp32/fp16/int8)
    arena_head_ratio: float = 0.25  # fp32 head fraction when the arena is tiered


@dataclasses.dataclass(frozen=True)
class PlacementPlan:
    placements: Dict[str, TablePlacement]
    arena: ArenaConfig = ArenaConfig()

    @classmethod
    def single_arena(cls, tables: Sequence[TableConfig], **arena_kw) -> "PlacementPlan":
        """The paper's layout: every table GROUPED into one shared cache."""
        arena = ArenaConfig(**arena_kw)
        return cls(
            placements={t.name: TablePlacement(Placement.GROUPED) for t in tables},
            arena=arena,
        )


@dataclasses.dataclass(frozen=True)
class ShardAssignment:
    """Frequency-driven shard assignment of one cached slab's ranked rows
    (host numpy, as in the reference): ``owner[r]`` / ``local[r]`` place
    rank ``r`` on a shard and a row there.  Replicated ranks (``r <
    replicate_top_k``) keep a home too, appended after the routed ranks, and
    carry no routed load."""

    num_shards: int
    owner: np.ndarray  # int32 [vocab] rank -> owning shard
    local: np.ndarray  # int32 [vocab] rank -> row on the owner
    shard_rows: np.ndarray  # int64 [S] real rows per shard
    shard_load: np.ndarray  # float64 [S] expected routed traffic per shard
    replicate_top_k: int = 0

    @property
    def rows_per_shard(self) -> int:
        """Uniform local vocab of the stacked ``[S, rows_per_shard, ...]`` layout."""
        return -(-int(self.owner.shape[0]) // self.num_shards)

    def imbalance(self) -> float:
        """max / mean expected routed traffic across shards (1.0 = even)."""
        mean = float(np.mean(self.shard_load))
        return float(np.max(self.shard_load)) / mean if mean > 0 else 1.0


class PlacementPlanner:
    """The planner's static device-assignment pass (``assign_devices``).
    The budget-driven ``plan`` with DEVICE and CACHED placements arrives with
    a later slice."""

    @staticmethod
    def assign_devices(
        vocab: int,
        num_shards: int,
        counts_ranked: Optional[np.ndarray] = None,
        replicate_top_k: int = 0,
    ) -> ShardAssignment:
        """Spread a slab's ranked rows over ``num_shards`` shards, balancing
        expected traffic: greedy longest-processing-time over the routed
        ranks, hottest first, each to the least-loaded shard with room (at
        most ``ceil(vocab / S)`` rows each), ties broken by (rows held, shard).
        Without counts (or with one shard), round-robin over the routed
        ranks.  The ``replicate_top_k`` head ranks get their homes last, on
        the least-filled shards."""
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        S = int(num_shards)
        vocab = int(vocab)
        K = min(max(int(replicate_top_k), 0), vocab)
        cap = -(-vocab // S)
        routed = np.arange(K, vocab, dtype=np.int64)
        c = None
        if counts_ranked is not None:
            c = np.asarray(counts_ranked, np.float64)
            if c.shape[0] != vocab:
                raise ValueError(f"counts_ranked has {c.shape[0]} entries, want {vocab}")
        owner = np.empty((vocab,), np.int32)
        local = np.empty((vocab,), np.int32)
        if c is None or S == 1:
            seq = np.concatenate([routed, np.arange(K, dtype=np.int64)])
            pos = np.arange(vocab, dtype=np.int64)
            owner[seq] = (pos % S).astype(np.int32)
            local[seq] = (pos // S).astype(np.int32)
        else:
            hot_first = routed[np.argsort(-c[routed], kind="stable")]
            sizes = np.zeros((S,), np.int64)
            heap = [(0.0, 0, s) for s in range(S)]  # (load, rows held, shard)
            for r in hot_first:
                ld, size, s = heapq.heappop(heap)
                owner[r] = s
                local[r] = size
                sizes[s] = size + 1
                if size + 1 < cap:  # a full shard leaves the heap
                    heapq.heappush(heap, (ld + c[r], size + 1, s))
            rep_heap = [(int(sizes[s]), s) for s in range(S)]
            heapq.heapify(rep_heap)
            for r in range(K):
                size, s = heapq.heappop(rep_heap)
                owner[r] = s
                local[r] = size
                if size + 1 < cap:
                    heapq.heappush(rep_heap, (size + 1, s))
        load = np.zeros((S,), np.float64)
        if routed.size:
            np.add.at(load, owner[routed], c[routed] if c is not None else 1.0)
        return ShardAssignment(
            num_shards=S, owner=owner, local=local,
            shard_rows=np.bincount(owner, minlength=S).astype(np.int64),
            shard_load=load, replicate_top_k=K,
        )


@dataclasses.dataclass
class CachedSlab:
    """A two-tier cached arena: host table, cache state, raw id -> rank map."""

    full: HostStore
    cache: cache_lib.CacheState
    idx_map: torch.Tensor  # int32 [vocab] raw id -> freq-ranked row


@dataclasses.dataclass
class CollectionState:
    slabs: Dict[str, CachedSlab]


@dataclasses.dataclass
class CollectionPlan:
    slab_plans: Dict[str, cache_lib.CachePlan]
    addresses: Dict[str, torch.Tensor]  # feature -> slots (-1 pad)
    writeback: bool = True


def cached_slab_flush(ccfg: cache_lib.CacheConfig, slab: CachedSlab) -> CachedSlab:
    """Write every resident row back to the slab's host table (in place)."""
    full, cache_state = cache_lib.flush(ccfg, slab.full, slab.cache)
    return dataclasses.replace(slab, full=full, cache=cache_state)


def draw_table(seed: int, spec: "_CachedSlabSpec", device: torch.device):
    """The initial table of a slab, rank by rank: ``(first_rank, rows)``
    chunks of uniform(+-1/sqrt(dim)) host rows, drawn on ``device`` from
    ``seed``.  The sharded collection draws the same chunks, so the two
    start from one logical table."""
    scale = 1.0 / np.sqrt(spec.dim)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    for r0 in range(0, spec.vocab, _INIT_CHUNK_ROWS):
        n = min(_INIT_CHUNK_ROWS, spec.vocab - r0)
        chunk = torch.rand((n, spec.dim), generator=gen, dtype=spec.dtype, device=device)
        yield r0, (chunk * (2 * scale) - scale).cpu()


def slab_freq_stats(
    spec: "_CachedSlabSpec", counts: Optional[Mapping[str, np.ndarray]]
) -> Optional[freq_lib.FreqStats]:
    """The slab's frequency ranking from per-table counts (None without)."""
    if counts is None:
        return None
    return freq_lib.build_freq_stats(np.concatenate(
        [np.asarray(counts.get(t.name, np.zeros((t.vocab,), np.int64)), np.int64)
         for t in spec.tables]
    ))


def _translate(slab: CachedSlab, raw_ids: torch.Tensor) -> torch.Tensor:
    """Slab-global raw ids (-1 pad) -> freq-ranked rows (-1 pad)."""
    valid = raw_ids >= 0
    rows = take_fill(slab.idx_map, torch.where(valid, raw_ids, 0), -1)
    return torch.where(valid, rows, -1)


@dataclasses.dataclass(frozen=True)
class _CachedSlabSpec:
    """Static geometry of the shared arena."""

    tables: Tuple[TableConfig, ...]
    arena: ArenaConfig

    @property
    def vocab(self) -> int:
        return sum(t.vocab for t in self.tables)

    @property
    def dim(self) -> int:
        return self.tables[0].dim

    @property
    def dtype(self) -> torch.dtype:
        return self.tables[0].dtype

    @property
    def ids_per_step(self) -> int:
        return sum(t.ids_per_step for t in self.tables)

    @property
    def offsets(self) -> np.ndarray:
        return freq_lib.concat_table_offsets([t.vocab for t in self.tables])

    def unique_size(self, ids_per_step: Optional[int] = None) -> int:
        k = min(ids_per_step or self.ids_per_step, self.vocab)
        if self.arena.max_unique_per_step:
            k = min(k, self.arena.max_unique_per_step)
        return k

    @property
    def capacity(self) -> int:
        cap = max(int(self.arena.cache_ratio * self.vocab), self.unique_size())
        return min(cap, self.vocab)

    @property
    def head_capacity(self) -> int:
        """fp32 slots of the (possibly tiered) arena."""
        return self.cache_config().head_capacity

    def cache_config(self, ids_per_step: Optional[int] = None, writeback: bool = True):
        a = self.arena
        return cache_lib.CacheConfig(
            vocab=self.vocab,
            capacity=self.capacity,
            ids_per_step=ids_per_step or self.ids_per_step,
            buffer_rows=a.buffer_rows,
            policy=a.policy,
            writeback=writeback,
            max_unique_per_step=a.max_unique_per_step,
            protect_via_inverse=a.protect_via_inverse,
            freq_half_life=a.freq_half_life,
            use_pallas_plan=a.use_pallas_plan,
            arena_precision=a.arena_precision,
            arena_head_ratio=a.arena_head_ratio,
        )


class EmbeddingCollection:
    """N tables in one shared cache arena, behind one keyed-feature surface."""

    def __init__(self, tables: Sequence[TableConfig], plan: PlacementPlan):
        names = [t.name for t in tables]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate table names: {names}")
        dims = {(t.dim, t.dtype) for t in tables}
        if len(dims) != 1:
            raise ValueError(f"GROUPED tables must share (dim, dtype); got {dims}")
        self.tables: Dict[str, TableConfig] = {t.name: t for t in tables}
        self.plan = plan
        self.feature_to_table: Dict[str, str] = {}
        for t in tables:
            for f in t.features:
                if f in self.feature_to_table:
                    raise ValueError(f"feature {f!r} claimed by two tables")
                self.feature_to_table[f] = t.name
        spec = _CachedSlabSpec(tables=tuple(tables), arena=plan.arena)
        self.cached_slabs: Dict[str, _CachedSlabSpec] = {SHARED_ARENA: spec}
        self.table_slab: Dict[str, Tuple[str, int]] = {
            t.name: (SHARED_ARENA, int(off)) for t, off in zip(spec.tables, spec.offsets)
        }

    @classmethod
    def create(
        cls, tables: Sequence[TableConfig], budget_bytes: Optional[int] = None, **arena_kw
    ) -> "EmbeddingCollection":
        """The paper's layout: one shared cache arena over all tables."""
        if budget_bytes is not None:
            raise NotImplementedError("the placement planner arrives with a later slice")
        return cls(tables, PlacementPlan.single_arena(tables, **arena_kw))

    # ----- init -------------------------------------------------------------

    def split_concat_counts(self, counts: np.ndarray) -> Dict[str, np.ndarray]:
        """Split a concatenated-vocab count vector (table declaration order)
        into the per-table dict ``init`` expects."""
        out, off = {}, 0
        for t in self.tables.values():
            out[t.name] = np.asarray(counts[off : off + t.vocab])
            off += t.vocab
        if off != counts.shape[0]:
            raise ValueError(f"counts length {counts.shape[0]} != total vocab {off}")
        return out

    def init(
        self,
        seed: int,
        counts: Optional[Mapping[str, np.ndarray]] = None,
        warm: bool = True,
        device: DeviceLike = None,
    ) -> CollectionState:
        """Build the state: a host table of uniform(+-1/sqrt(dim)) rows drawn
        from ``seed``, an empty (or warmed) arena on ``device``.  On a CUDA
        device the rows are drawn on the card in chunks and land in a
        pinned host table.  A tiered ``arena_precision`` (fp16 / int8)
        builds the arena as an :class:`ArenaStore`."""
        dev = resolve_device(device)
        slabs = {}
        for sname, spec in self.cached_slabs.items():
            weight = torch.empty((spec.vocab, spec.dim), dtype=spec.dtype)
            for r0, chunk in draw_table(seed, spec, dev):
                weight[r0 : r0 + chunk.shape[0]] = chunk
            stats = slab_freq_stats(spec, counts)
            idx_map = (torch.from_numpy(stats.idx_map) if stats is not None
                       else torch.arange(spec.vocab, dtype=torch.int32))
            ccfg = spec.cache_config()
            slab = CachedSlab(
                full=HostStore.create({"weight": weight}, pin=dev.type == "cuda"),
                cache=cache_lib.init_cache(
                    ccfg, {"weight": torch.zeros((spec.dim,), dtype=spec.dtype)}, dev
                ),
                idx_map=idx_map.to(dev),
            )
            if warm:
                full, cache_state = cache_lib.warmup(ccfg, slab.full, slab.cache)
                slab = dataclasses.replace(slab, full=full, cache=cache_state)
            slabs[sname] = slab
        return CollectionState(slabs=slabs)

    # ----- the non-diff bookkeeping pass ------------------------------------

    def _slab_lanes(self, fb: FeatureBatch, sname: str) -> List[Tuple[str, int]]:
        member = {t.name for t in self.cached_slabs[sname].tables}
        return [
            (f, int(fb.ids[f].numel())) for f in fb.features
            if self.feature_to_table.get(f) in member
        ]

    def _slab_raw(self, fb: FeatureBatch, sname: str) -> Optional[torch.Tensor]:
        """Flat offset-translated id vector of this slab's lanes in ``fb``."""
        parts = []
        for f, _ in self._slab_lanes(fb, sname):
            ids = fb.ids[f].reshape(-1).to(torch.int32)
            off = self.table_slab[self.feature_to_table[f]][1]
            parts.append(torch.where(ids >= 0, ids + off, -1))
        if not parts:
            return None
        return torch.cat(parts) if len(parts) > 1 else parts[0]

    def plan_prepare(
        self, state: CollectionState, fb: FeatureBatch, writeback: bool = True
    ) -> CollectionPlan:
        """Planning half of ``prepare``: per-slab cache plans plus addresses."""
        for f in fb.features:
            if f not in self.feature_to_table:
                raise KeyError(f"unknown feature {f!r}; known: {sorted(self.feature_to_table)}")
        addresses: Dict[str, torch.Tensor] = {}
        slab_plans: Dict[str, cache_lib.CachePlan] = {}
        for sname, spec in self.cached_slabs.items():
            raw = self._slab_raw(fb, sname)
            if raw is None:
                continue
            slab = state.slabs[sname]
            ccfg = spec.cache_config(ids_per_step=int(raw.shape[0]), writeback=writeback)
            plan = cache_lib.plan_prepare(ccfg, slab.cache, _translate(slab, raw))
            slab_plans[sname] = plan
            pos = 0
            for f, n in self._slab_lanes(fb, sname):
                addresses[f] = plan.slots[pos : pos + n].reshape(fb.ids[f].shape)
                pos += n
        return CollectionPlan(slab_plans=slab_plans, addresses=addresses, writeback=writeback)

    def apply_plan(self, state: CollectionState, plan: CollectionPlan) -> CollectionState:
        """Apply half: execute each slab's row movement (in place on the
        arena and, with writeback, the host table) and install the index
        images."""
        slabs = dict(state.slabs)
        for sname, p in plan.slab_plans.items():
            ccfg = self.cached_slabs[sname].cache_config(writeback=plan.writeback)
            slab = slabs[sname]
            full, cache_state = cache_lib.apply_plan(ccfg, slab.full, slab.cache, p)
            slabs[sname] = dataclasses.replace(slab, full=full, cache=cache_state)
        return CollectionState(slabs=slabs)

    def prepare(
        self, state: CollectionState, fb: FeatureBatch, writeback: bool = True
    ) -> Tuple[CollectionState, Dict[str, torch.Tensor]]:
        """Make every requested row resident; return per-feature slots."""
        p = self.plan_prepare(state, fb, writeback=writeback)
        return self.apply_plan(state, p), p.addresses

    # ----- read path --------------------------------------------------------

    def weights(self, state: CollectionState) -> Dict[str, torch.Tensor]:
        """The trainable fast-tier weights, keyed by slab: differentiate the
        loss w.r.t. this dict and feed the grads to ``apply_grads``.  A
        tiered arena returns its full decoded ``[capacity, dim]`` view (the
        straight-through scheme of arXiv 2010.11305)."""
        out = {}
        for sname in self.cached_slabs:
            cached = state.slabs[sname].cache.cached_rows
            out[sname] = (cached.decode_leaf("weight") if isinstance(cached, ArenaStore)
                          else cached["weight"])
        return out

    def gather(
        self,
        weights: Mapping[str, torch.Tensor],
        addresses: Mapping[str, torch.Tensor],
        fb: FeatureBatch,
    ) -> Dict[str, torch.Tensor]:
        """feature -> rows of shape ``ids.shape + (dim,)``; -1 lanes are zero.

        One ``take_fill`` per slab over all its features' lanes: the
        backward builds ONE dense ``[capacity, dim]`` gradient (not one per
        feature) and accumulates duplicate ids with ``index_add_``, which
        the card does with atomics (so its summation order is not fixed)."""
        by_slab: Dict[str, List[str]] = {}
        for f in fb.features:
            by_slab.setdefault(self.table_slab[self.feature_to_table[f]][0], []).append(f)
        out = {}
        for sname, feats in by_slab.items():
            w = weights[sname]
            flat = torch.cat([addresses[f].reshape(-1) for f in feats])
            rows = take_fill(w, flat, 0.0)
            parts = rows.split([addresses[f].numel() for f in feats])
            for f, part in zip(feats, parts):
                out[f] = part.reshape(addresses[f].shape + (w.shape[-1],))
        return out

    def pool(
        self,
        rows: Mapping[str, torch.Tensor],
        fb: FeatureBatch,
        combiner: str = "sum",
        *,
        weights: Optional[Mapping[str, torch.Tensor]] = None,
        addresses: Optional[Mapping[str, torch.Tensor]] = None,
        use_pallas: bool = False,
        max_bag: int = 0,
    ) -> Dict[str, torch.Tensor]:
        """Segment-reduce bag features ([lanes, dim] -> [num_segments, dim]);
        one-hot features pass through.

        With ``use_pallas`` (and ``weights`` + ``addresses`` from the same
        step), bag features skip the per-lane ``rows``: the embedding-bag
        kernel gathers and pools straight off the fast-tier weights, with
        the cache slots as its ids (-1 lanes are padding), one launch per
        slab for all of the slab's bag features (the reference loops over
        the features; the result is the same); differentiable w.r.t.
        ``weights``, with one backward per slab.  The segment-sum route
        below is the reference for it."""
        out = dict(rows)
        if use_pallas and (weights is None or addresses is None):
            raise ValueError("use_pallas pooling needs weights= and addresses=")
        if use_pallas:
            from repro_torch.kernels.embedding_bag import ops as eb_ops

            by_slab: Dict[str, List[str]] = {}
            for f in fb.segments:
                by_slab.setdefault(self.table_slab[self.feature_to_table[f]][0], []).append(f)
            pooled = {}
            for sname, feats in by_slab.items():
                flat = [addresses[f].reshape(-1) for f in feats]
                offsets = [0]
                for x in flat:
                    offsets.append(offsets[-1] + x.shape[0])
                stacked = eb_ops.embedding_bag_multi(
                    weights[sname], torch.cat(flat), torch.cat([fb.segments[f] for f in feats]),
                    offsets, fb.num_segments, combiner=combiner, max_bag=max_bag,
                )
                pooled.update(zip(feats, torch.unbind(stacked)))
            for f in fb.segments:  # in the batch's feature order
                out[f] = pooled[f]
            return out
        for f, seg in fb.segments.items():
            pooled = segment_sum(rows[f], seg, fb.num_segments)
            if combiner == "mean":
                cnt = segment_sum((fb.ids[f] >= 0).to(pooled.dtype), seg, fb.num_segments)
                pooled = pooled / torch.clamp_min(cnt, 1.0)[:, None]
            out[f] = pooled
        return out

    def lookup(self, state: CollectionState, fb: FeatureBatch, writeback: bool = True):
        """Convenience prepare+gather: (state', addresses, feature -> rows)."""
        state, addresses = self.prepare(state, fb, writeback=writeback)
        return state, addresses, self.gather(self.weights(state), addresses, fb)

    # ----- updates ----------------------------------------------------------

    def apply_grads(
        self, state: CollectionState, grads: Mapping[str, torch.Tensor], lr
    ) -> CollectionState:
        """Synchronous SGD on the fast tier (paper §2.2.3: resident rows are
        authoritative; the host tier catches up at eviction or flush), in
        place.  A tiered arena steps on its decoded view, then stores the
        head raw and re-encodes the tail (rows with a zero gradient
        re-encode to the identical payload)."""
        for sname in self.cached_slabs:
            cached = state.slabs[sname].cache.cached_rows
            if isinstance(cached, ArenaStore):
                w = cached.decode_leaf("weight")
                cached.replace_leaf("weight", w - lr * grads[sname])
            else:
                cached["weight"].sub_(lr * grads[sname])
        return CollectionState(slabs=dict(state.slabs))

    def flush(self, state: CollectionState) -> CollectionState:
        """Checkpoint barrier: every cached slab writes its residents back."""
        return CollectionState(slabs={
            sname: cached_slab_flush(spec.cache_config(), state.slabs[sname])
            for sname, spec in self.cached_slabs.items()
        })

    def dense_reference(self, state: CollectionState, fb: FeatureBatch) -> Dict[str, torch.Tensor]:
        """Rows read straight out of the host table through ``idx_map``: the
        uncached oracle (exact for a read-only cache, or after a flush)."""
        out = {}
        for f in fb.features:
            sname, off = self.table_slab[self.feature_to_table[f]]
            slab = state.slabs[sname]
            ids = fb.ids[f].reshape(-1)
            raw = torch.where(ids >= 0, ids + off, -1)
            rows = _translate(slab, raw).cpu()
            full = slab.full.decode_rows(rows)["weight"]
            out[f] = full.reshape(fb.ids[f].shape + (full.shape[-1],))
        return out

    def full_lookup(self, state: CollectionState, table: str, local_ids: torch.Tensor
                    ) -> torch.Tensor:
        """Rows of ``table``'s local ids read straight out of the host table
        (-1 lanes give zero rows), on the host."""
        sname, off = self.table_slab[table]
        slab = state.slabs[sname]
        raw = torch.where(local_ids >= 0, local_ids + off, -1)
        return slab.full.decode_rows(_translate(slab, raw).cpu())["weight"]

    # ----- telemetry ----------------------------------------------------------

    def device_bytes(self) -> Dict[str, object]:
        """Device-resident vs host-tier footprint of the single arena: the
        arena's weight bytes (fp32 head + encoded tail + sideband when
        tiered), its index maps and tracker, and the fp32 host table."""
        per_slab: Dict[str, int] = {}
        slow = fast_fp32 = fast_actual = 0
        for sname, spec in self.cached_slabs.items():
            item = spec.dtype.itemsize
            w = tiered_arena_bytes(spec.capacity, spec.head_capacity, spec.dim, spec.dtype,
                                   spec.arena.arena_precision)
            # slot_to_row, last_used, use_count; row_to_slot, idx_map, tracker (2)
            per_slab[sname] = w + spec.capacity * 4 * 3 + spec.vocab * 4 * 4
            fast_actual += w
            fast_fp32 += spec.capacity * spec.dim * item
            slow += spec.vocab * spec.dim * item
        return {
            "device_total": sum(per_slab.values()),
            "slow_tier_bytes": slow,
            "host_bytes_saved": 0,
            "arena_bytes_saved": fast_fp32 - fast_actual,
            "per_slab": per_slab,
            "budget_bytes": None,
        }

    def metrics(self, state: CollectionState, writeback: bool = True) -> Dict[str, object]:
        """Cache telemetry over the cached slabs, as in the reference: int32
        cumulative counters per slab (reconstructed exactly by the obs hub),
        plus the float32 convenience scalars."""
        hits = misses = evictions = overflows = 0
        win_h = win_m = 0.0
        ref_swaps = ref_rows = 0
        wire = 0.0
        per = {k: {} for k in (
            "host_moved_rows", "host_row_bytes", "slab_hits", "slab_misses",
            "slab_refresh_swaps", "slab_refresh_rows", "slab_tier_promotions",
            "slab_tier_demotions")}
        for sname in self.cached_slabs:
            # a sharded slab stacks every counter [S]: the sums fold them
            # into one wrapping int32 per slab (0-dim counters pass through)
            c = state.slabs[sname].cache
            tr = c.tracker
            hits, misses = hits + i32(c.hits.sum()), misses + i32(c.misses.sum())
            evictions = evictions + i32(c.evictions.sum())
            overflows = overflows + i32(c.uniq_overflows.sum())
            win_h, win_m = win_h + tr.win_hits.sum(), win_m + tr.win_misses.sum()
            ref_swaps = ref_swaps + i32(tr.refresh_swaps.sum())
            ref_rows = ref_rows + i32(tr.refresh_rows.sum())
            per["slab_hits"][sname] = i32(c.hits.sum())
            per["slab_misses"][sname] = i32(c.misses.sum())
            per["slab_refresh_swaps"][sname] = i32(tr.refresh_swaps.sum())
            per["slab_refresh_rows"][sname] = i32(tr.refresh_rows.sum())
            per["slab_tier_promotions"][sname] = i32(c.tier_promotions.sum())
            per["slab_tier_demotions"][sname] = i32(c.tier_demotions.sum())
            full = state.slabs[sname].full
            row_bytes = full.row_wire_bytes(batch_dims=full["weight"].dim() - 1)
            moved = i32((c.misses + c.evictions if writeback else c.misses).sum())
            per["host_moved_rows"][sname] = moved
            per["host_row_bytes"][sname] = torch.tensor(
                row_bytes, dtype=torch.int32, device=c.hits.device
            )
            wire = wire + moved.to(torch.float32) * row_bytes
        tot = hits + misses
        win_tot = win_h + win_m
        return {
            "hit_rate": torch.where(tot > 0, hits / torch.clamp(tot, min=1), 0.0),
            "window_hit_rate": torch.where(
                win_tot > 0, win_h / torch.clamp(win_tot, min=1e-9), 0.0
            ),
            "refresh_swaps": ref_swaps,
            "refresh_rows_moved": ref_rows,
            "cache_misses": misses,
            "cache_evictions": evictions,
            "uniq_overflows": overflows,
            "host_wire_bytes": wire,
            **per,
        }
