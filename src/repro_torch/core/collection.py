"""Keyed-feature embeddings under a placement plan (port of the unsharded
``repro.core.collection``).

The paper manages ONE concatenated, frequency-ordered table through one
software cache: every table GROUPED into the shared arena
(``PlacementPlan.single_arena``, what ``create`` builds without a budget).
Its device-budget mode (``create(budget_bytes=)``, the
:class:`PlacementPlanner`) places each table on one of three tiers:

* DEVICE — the whole table resident on the card, no cache bookkeeping;
* CACHED — the table's own two-tier cache (its own ratio, policy and
  codecs), the planner scaling the ratios down to fit the budget;
* GROUPED — small tables sharing the one cache arena.

Each cached slab's host tier is a :class:`HostStore` encoded by its
``host_precision`` (fp32 / fp16 / int8, or "auto": ``PrecisionPolicy``
picks from the frequency counts at ``init``); its arena is fp32 or
frequency-tiered (``arena_precision`` fp16 / int8 / "auto").  The surface:
``init`` / ``plan_prepare`` / ``apply_plan`` / ``prepare`` / ``weights`` /
``gather`` / ``pool`` / ``lookup`` / ``apply_grads`` / ``flush`` /
``full_lookup`` / ``dense_reference`` / ``metrics`` / ``device_bytes``,
and the lookahead window of the pipelined trainer (``plan_prepare(
fb_future=)``, ``prepare_lookahead``).  ``chunk_rows`` (per table, or the
shared arena's) stages a slab's host side in whole chunks.  ``refresh``
re-ranks every cached slab from its online decayed counters
(``core.refresh``).

On a CUDA device a cached slab's host tier is pinned in host memory; the
arena, the index maps, ``idx_map`` and every DEVICE table live on the card.
"""
from __future__ import annotations

import dataclasses
import enum
import heapq
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.analysis.contracts import INT_COUNTERS, METRICS_INT_COUNTERS, contract
from repro_torch.core import cache as cache_lib
from repro_torch.core import freq as freq_lib
from repro_torch.core import refresh as refresh_lib
from repro_torch.core.lanes import i32, segment_sum, take_fill
from repro_torch.core.policies import Policy
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.store.arena import ArenaStore, tiered_arena_bytes
from repro_torch.store.codec import get_codec
from repro_torch.store.host_store import HostStore
from repro_torch.store.policy import PrecisionPolicy, SlabGeometry

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
    "DeviceSlab",
    "CachedSlab",
    "CollectionState",
    "CollectionPlan",
    "cached_slab_apply",
    "cached_slab_flush",
    "cached_slab_gather",
    "cached_slab_plan",
    "cached_slab_prepare",
    "cached_slab_warmup",
]

SHARED_ARENA = "__shared__"
_INIT_CHUNK_ROWS = 1 << 20  # table init: rows drawn per device chunk


class Placement(enum.Enum):
    DEVICE = "device"  # the whole table resident on the card, no cache bookkeeping
    CACHED = "cached"  # the paper's two-tier cache, the table's own ratio and policy
    GROUPED = "grouped"  # shares the collection-wide cache arena (the paper)


@dataclasses.dataclass(frozen=True)
class TableConfig:
    """One logical embedding table.  ``ids_per_step`` (the id lanes its
    features bring a step) sizes the unique buffer and the minimum cache
    capacity.  The cache knobs apply when the table is CACHED; GROUPED
    tables use the shared arena's (``ArenaConfig``), DEVICE tables have
    none.  ``host_precision`` / ``arena_precision`` None defer to the
    planner or the collection-wide setting."""

    name: str
    vocab: int
    dim: int
    ids_per_step: int
    feature_names: Tuple[str, ...] = ()
    cache_ratio: float = 0.015  # the paper's 1.5 %
    policy: Policy = Policy.FREQ_LFU
    buffer_rows: int = 65536
    max_unique_per_step: int = 0
    protect_via_inverse: bool = True
    dtype: torch.dtype = torch.float32
    placement: Optional[Placement] = None  # planner override
    host_precision: Optional[str] = None  # fp32 / fp16 / int8 / auto
    arena_precision: Optional[str] = None  # fp32 / fp16 / int8 / auto
    freq_half_life: int = 1024
    use_pallas_plan: bool = False
    chunk_rows: int = 0  # host-side staging in whole chunks (0 = rows)

    @property
    def features(self) -> Tuple[str, ...]:
        return self.feature_names or (self.name,)

    @property
    def full_bytes(self) -> int:
        return self.vocab * self.dim * self.dtype.itemsize

    def unique_size(self, ids_per_step: Optional[int] = None) -> int:
        k = min(ids_per_step or self.ids_per_step, self.vocab)
        if self.max_unique_per_step:
            k = min(k, self.max_unique_per_step)
        return k


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
    # effective ratio of a CACHED / GROUPED table (None: the table's own);
    # 0.0 is meaningful: the planner shrank it to the one-batch floor
    cache_ratio: Optional[float] = None
    host_precision: Optional[str] = None  # host-tier codec; None: the table's own / fp32
    arena_precision: Optional[str] = None  # arena tail codec; None: the table's own / fp32


@dataclasses.dataclass(frozen=True)
class ArenaConfig:
    """Knobs of one cache arena: the shared GROUPED arena's, or (built from
    a ``TableConfig`` and its placement) a CACHED table's own."""

    cache_ratio: float = 0.015
    policy: Policy = Policy.FREQ_LFU
    buffer_rows: int = 65536
    max_unique_per_step: int = 0
    protect_via_inverse: bool = True
    freq_half_life: int = 1024
    use_pallas_plan: bool = False
    host_precision: str = "fp32"  # the host tier's codec (fp32/fp16/int8/auto)
    arena_precision: str = "fp32"  # the arena's device-tail codec (fp32/fp16/int8/auto)
    arena_head_ratio: float = 0.25  # fp32 head fraction when the arena is tiered
    chunk_rows: int = 0  # host-side staging in whole chunks (0 = rows)


@dataclasses.dataclass(frozen=True)
class PlacementPlan:
    placements: Dict[str, TablePlacement]
    arena: ArenaConfig = ArenaConfig()
    budget_bytes: Optional[int] = None

    @classmethod
    def single_arena(cls, tables: Sequence[TableConfig], **arena_kw) -> "PlacementPlan":
        """The paper's layout: every table GROUPED into one shared cache."""
        arena = ArenaConfig(**arena_kw)
        return cls(
            placements={
                t.name: TablePlacement(Placement.GROUPED, arena.cache_ratio,
                                       host_precision=arena.host_precision,
                                       arena_precision=arena.arena_precision)
                for t in tables
            },
            arena=arena,
        )

    def summary(self) -> Dict[str, str]:
        """table -> ``placement[@ratio][:host codec][/arena:codec]``."""
        out = {}
        for n, p in self.placements.items():
            s = p.placement.value
            if p.placement is not Placement.DEVICE:
                s += f"@{p.cache_ratio:.4f}" if p.cache_ratio is not None else ""
                hp = p.host_precision or "fp32"
                if hp != "fp32":
                    s += f":{hp}"
                ap = p.arena_precision or "fp32"
                if ap != "fp32":
                    s += f"/arena:{ap}"
            out[n] = s
        return out


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
    """Assign each table a memory tier under a device-byte budget
    (deterministic, as in the reference):

    1. explicit ``TableConfig.placement`` overrides hold;
    2. tables below ``group_below_rows`` rows share the GROUPED arena;
    3. the rest are promoted to DEVICE hottest-per-byte first (access
       counts per byte with counts, smallest first without), each only if
       the rest of the plan still fits with every remaining cached table at
       its one-batch floor;
    4. everything else is CACHED at its own ratio, all ratios scaled down
       uniformly when the fast tiers overflow what is left, floored at one
       batch's unique rows (an infeasible floor raises).

    It also stamps each cached table's codecs: the table's own
    ``host_precision`` / ``arena_precision`` win, then the planner-wide
    ones; "auto" is priced at ``PrecisionPolicy().no_stats`` and resolved
    by ``EmbeddingCollection.init``.  ``assign_devices`` is the sharded
    collection's per-slab device-assignment pass."""

    def __init__(
        self,
        budget_bytes: int,
        group_below_rows: int = 0,
        arena: Optional[ArenaConfig] = None,
        host_precision: Optional[str] = None,
        arena_precision: Optional[str] = None,
        arena_head_ratio: float = 0.25,
    ):
        self.budget_bytes = int(budget_bytes)
        self.group_below_rows = int(group_below_rows)
        self.arena = arena if arena is not None else ArenaConfig()
        self.host_precision = host_precision
        self.arena_precision = arena_precision
        self.arena_head_ratio = float(arena_head_ratio)

    @staticmethod
    def _tiered_weight_bytes(
        capacity: int, dim: int, dtype: torch.dtype, arena_precision: Optional[str],
        head_ratio: float,
    ) -> int:
        """Weight bytes of one arena at ``arena_precision``: fp32 head +
        encoded tail payload + tail sideband ("auto" at the no-stats pick)."""
        ap = arena_precision or "fp32"
        if ap == "auto":
            ap = PrecisionPolicy().no_stats
        if ap == "fp32":
            head = capacity
        else:
            head = min(capacity, max(1, int(round(head_ratio * capacity))))
        return tiered_arena_bytes(capacity, head, dim, dtype, ap)

    def _table_arena_precision(self, t: TableConfig) -> Optional[str]:
        return t.arena_precision or self.arena_precision

    def _fast_bytes(self, t: TableConfig, ratio: float) -> int:
        """Device bytes of one CACHED table at ``ratio``: the arena, three
        int32 per slot (slot_to_row, last_used, use_count) and four per row
        (row_to_slot, idx_map, the tracker's score and last_touch)."""
        cap = min(max(int(ratio * t.vocab), t.unique_size()), t.vocab)
        w = self._tiered_weight_bytes(cap, t.dim, t.dtype, self._table_arena_precision(t),
                                      self.arena_head_ratio)
        return w + cap * 4 * 3 + t.vocab * 4 * 4

    def _arena_bytes(self, grouped: Sequence[TableConfig]) -> int:
        if not grouped:
            return 0
        gvocab = sum(t.vocab for t in grouped)
        gids = sum(t.ids_per_step for t in grouped)
        gcap = min(max(int(self.arena.cache_ratio * gvocab), min(gids, gvocab)), gvocab)
        w = self._tiered_weight_bytes(
            gcap, grouped[0].dim, grouped[0].dtype,
            self.arena_precision or self.arena.arena_precision, self.arena.arena_head_ratio,
        )
        return w + gcap * 4 * 3 + gvocab * 4 * 4

    def plan(
        self, tables: Sequence[TableConfig], counts: Optional[Mapping[str, np.ndarray]] = None
    ) -> PlacementPlan:
        placements: Dict[str, TablePlacement] = {}
        device_bytes = 0
        undecided: List[TableConfig] = []
        grouped: List[TableConfig] = []
        solo: List[TableConfig] = []
        for t in tables:
            if t.placement is Placement.DEVICE:
                placements[t.name] = TablePlacement(Placement.DEVICE)
                device_bytes += t.full_bytes
            elif t.placement is Placement.GROUPED:
                grouped.append(t)
            elif t.placement is Placement.CACHED:
                solo.append(t)
            elif t.vocab < self.group_below_rows:
                grouped.append(t)
            else:
                undecided.append(t)

        def heat_per_byte(t: TableConfig) -> float:
            if counts is not None and t.name in counts:
                return float(np.sum(counts[t.name])) / max(t.full_bytes, 1)
            return 1.0 / max(t.full_bytes, 1)

        undecided.sort(key=lambda t: (-heat_per_byte(t), t.name))
        for i, t in enumerate(undecided):
            rest = undecided[i + 1 :] + solo
            floor_rest = sum(self._fast_bytes(r, 0.0) for r in rest)
            cost = device_bytes + t.full_bytes + floor_rest + self._arena_bytes(grouped)
            if cost <= self.budget_bytes:
                placements[t.name] = TablePlacement(Placement.DEVICE)
                device_bytes += t.full_bytes
            else:
                solo.append(t)

        # the planner-wide codecs govern the shared arena too
        arena = dataclasses.replace(
            self.arena,
            host_precision=self.host_precision or self.arena.host_precision,
            arena_precision=self.arena_precision or self.arena.arena_precision,
        )
        for t in grouped:
            placements[t.name] = TablePlacement(Placement.GROUPED, arena.cache_ratio,
                                                host_precision=arena.host_precision,
                                                arena_precision=arena.arena_precision)

        remaining = self.budget_bytes - device_bytes - self._arena_bytes(grouped)
        want = sum(self._fast_bytes(t, t.cache_ratio) for t in solo)
        scale = 1.0
        if solo and want > remaining:
            floor = sum(self._fast_bytes(t, 0.0) for t in solo)
            if floor > remaining:
                raise ValueError(
                    f"budget {self.budget_bytes} cannot hold even one batch's unique rows "
                    f"per cached table (need >= {self.budget_bytes - remaining + floor})"
                )
            # weight bytes scale ~linearly with the ratio: solve for the shrink
            scale = max(0.0, (remaining - floor) / max(want - floor, 1))
        for t in solo:
            placements[t.name] = TablePlacement(
                Placement.CACHED, t.cache_ratio * scale,
                host_precision=t.host_precision or self.host_precision,
                arena_precision=self._table_arena_precision(t),
            )
        return PlacementPlan(placements=placements, arena=arena, budget_bytes=self.budget_bytes)

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
class DeviceSlab:
    """A fully resident table: the weight alone, no cache bookkeeping."""

    weight: torch.Tensor  # [vocab, dim] on the device


@dataclasses.dataclass
class CachedSlab:
    """A two-tier cached arena (one CACHED table, or the GROUPED group): host
    table, cache state, raw id -> rank map."""

    full: HostStore
    cache: cache_lib.CacheState
    idx_map: torch.Tensor  # int32 [vocab] raw id -> freq-ranked row


@dataclasses.dataclass
class CollectionState:
    slabs: Dict[str, Union[DeviceSlab, CachedSlab]]


@dataclasses.dataclass
class CollectionPlan:
    """Per-slab cache plans and per-feature addresses.  With a lookahead
    window, ``future_addresses[j]`` are the addresses of ``fb_future[j]``'s
    lanes under the post-apply index image and ``future_unresident``
    counts the window lanes whose row will not be resident (dropped under
    capacity pressure, or in a slab only the window touches): a trainer
    that runs a whole group off one plan needs it at 0."""

    slab_plans: Dict[str, cache_lib.CachePlan]
    addresses: Dict[str, torch.Tensor]  # feature -> slots, or a DEVICE table's rows (-1 pad)
    future_addresses: Tuple[Dict[str, torch.Tensor], ...] = ()
    future_unresident: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.zeros((), dtype=torch.int32))
    writeback: bool = True
    # the arena gradient's rows on the data axis: a sharded plan's at data > 1
    grad_rows: Tuple[Dict[str, torch.Tensor], ...] = ()


def draw_chunks(seed: Union[int, torch.Generator], vocab: int, dim: int, dtype: torch.dtype,
                device: torch.device) -> Iterator[Tuple[int, torch.Tensor]]:
    """A table's initial rows, rank by rank: ``(first_rank, rows)`` chunks of
    uniform(+-1/sqrt(dim)) rows drawn on ``device`` from ``seed`` (an int,
    or a generator on ``device``)."""
    scale = 1.0 / np.sqrt(dim)
    gen = (seed if isinstance(seed, torch.Generator)
           else torch.Generator(device=device).manual_seed(int(seed)))
    for r0 in range(0, vocab, _INIT_CHUNK_ROWS):
        n = min(_INIT_CHUNK_ROWS, vocab - r0)
        chunk = torch.rand((n, dim), generator=gen, dtype=dtype, device=device)
        yield r0, chunk * (2 * scale) - scale


def slab_counts(spec: "_CachedSlabSpec", counts: Optional[Mapping[str, np.ndarray]]
                ) -> Optional[np.ndarray]:
    """The slab's concatenated per-table counts (None without counts)."""
    if counts is None:
        return None
    return np.concatenate(
        [np.asarray(counts.get(t.name, np.zeros((t.vocab,), np.int64)), np.int64)
         for t in spec.tables]
    )


# --- slab-level ops (the single-arena core; ``core.cached_embedding``
#     adapts its one-big-table API onto exactly these) ---------------------


def _translate(slab: CachedSlab, raw_ids: torch.Tensor) -> torch.Tensor:
    """Slab-global raw ids (-1 pad) -> freq-ranked rows (-1 pad)."""
    valid = raw_ids >= 0
    rows = take_fill(slab.idx_map, torch.where(valid, raw_ids, 0), -1)
    return torch.where(valid, rows, -1)


def _read_full_rows(full: Union[HostStore, Dict[str, torch.Tensor]], rows: torch.Tensor
                    ) -> torch.Tensor:
    """Weight rows of a host tier, decoded when it is a :class:`HostStore`,
    raw otherwise; negative lanes give zero rows (the oracle's bulk read).
    On the device of ``rows``."""
    if isinstance(full, HostStore):
        return full.decode_rows(rows.cpu())["weight"].to(rows.device)
    w = full["weight"]
    return take_fill(w, rows.to(w.device), 0).to(rows.device)


def cached_slab_plan(
    ccfg: cache_lib.CacheConfig,
    slab: CachedSlab,
    raw_ids: torch.Tensor,
    raw_future: Optional[torch.Tensor] = None,
) -> cache_lib.CachePlan:
    """Planning half of :func:`cached_slab_prepare`: ids in, movement plan
    out, no weights touched (see ``cache.plan_prepare``)."""
    fut = None if raw_future is None else _translate(slab, raw_future)
    return cache_lib.plan_prepare(ccfg, slab.cache, _translate(slab, raw_ids), future_rows=fut)


def cached_slab_apply(
    ccfg: cache_lib.CacheConfig, slab: CachedSlab, plan: cache_lib.CachePlan
) -> CachedSlab:
    """Apply half: the planned row movement on this slab's weights (in
    place: ``slab`` must not be used again)."""
    full, cache_state = cache_lib.apply_plan(ccfg, slab.full, slab.cache, plan)
    return dataclasses.replace(slab, full=full, cache=cache_state)


def cached_slab_prepare(
    ccfg: cache_lib.CacheConfig, slab: CachedSlab, raw_ids: torch.Tensor
) -> Tuple[CachedSlab, torch.Tensor]:
    """Make every row of ``raw_ids`` (slab-global, -1 pad) resident;
    returns the slab and each lane's slot."""
    plan = cached_slab_plan(ccfg, slab, raw_ids)
    return cached_slab_apply(ccfg, slab, plan), plan.slots


def cached_slab_gather(slab: CachedSlab, slots: torch.Tensor) -> torch.Tensor:
    """Differentiable gather from the cached weight (padding -> zero rows)."""
    return cache_lib.lookup_slots(slab.cache, slots, leaf="weight")


def cached_slab_flush(ccfg: cache_lib.CacheConfig, slab: CachedSlab) -> CachedSlab:
    """Write every resident row back to the slab's host table (in place)."""
    full, cache_state = cache_lib.flush(ccfg, slab.full, slab.cache)
    return dataclasses.replace(slab, full=full, cache=cache_state)


def cached_slab_warmup(ccfg: cache_lib.CacheConfig, slab: CachedSlab) -> CachedSlab:
    """Fill the arena with the hottest (lowest-rank) rows (paper §4.3)."""
    full, cache_state = cache_lib.warmup(ccfg, slab.full, slab.cache)
    return dataclasses.replace(slab, full=full, cache=cache_state)


@dataclasses.dataclass(frozen=True)
class _CachedSlabSpec:
    """Static geometry of one cached slab (a CACHED table or the shared
    arena) and its arena knobs."""

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
            chunk_rows=a.chunk_rows,
            # an unresolved "auto" structures like the policy's no-stats pick;
            # init replaces it with the resolved codec before any state exists
            arena_precision=(PrecisionPolicy().no_stats if a.arena_precision == "auto"
                             else a.arena_precision),
            arena_head_ratio=a.arena_head_ratio,
        )


class EmbeddingCollection:
    """N tables under one placement plan, behind one keyed-feature surface."""

    def __init__(self, tables: Sequence[TableConfig], plan: PlacementPlan):
        names = [t.name for t in tables]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate table names: {names}")
        missing = [n for n in names if n not in plan.placements]
        if missing:
            raise ValueError(f"plan is missing placements for tables: {missing}")
        self.tables: Dict[str, TableConfig] = {t.name: t for t in tables}
        self.plan = plan
        self.feature_to_table: Dict[str, str] = {}
        for t in tables:
            for f in t.features:
                if f in self.feature_to_table:
                    raise ValueError(f"feature {f!r} claimed by two tables")
                self.feature_to_table[f] = t.name
        # DEVICE and CACHED tables are a slab each; GROUPED tables share one
        self.device_slabs: Dict[str, TableConfig] = {}
        self.cached_slabs: Dict[str, _CachedSlabSpec] = {}
        grouped: List[TableConfig] = []
        for t in tables:
            p = plan.placements[t.name]
            if p.placement is Placement.DEVICE:
                self.device_slabs[t.name] = t
            elif p.placement is Placement.CACHED:
                self.cached_slabs[t.name] = _CachedSlabSpec(tables=(t,), arena=ArenaConfig(
                    cache_ratio=t.cache_ratio if p.cache_ratio is None else p.cache_ratio,
                    policy=t.policy,
                    buffer_rows=t.buffer_rows,
                    max_unique_per_step=t.max_unique_per_step,
                    protect_via_inverse=t.protect_via_inverse,
                    freq_half_life=t.freq_half_life,
                    use_pallas_plan=t.use_pallas_plan,
                    chunk_rows=t.chunk_rows,
                    host_precision=p.host_precision or t.host_precision or "fp32",
                    arena_precision=p.arena_precision or t.arena_precision or "fp32",
                ))
            else:
                grouped.append(t)
        if grouped:
            dims = {(t.dim, t.dtype) for t in grouped}
            if len(dims) != 1:
                raise ValueError(f"GROUPED tables must share (dim, dtype); got {dims}")
            self.cached_slabs[SHARED_ARENA] = _CachedSlabSpec(tables=tuple(grouped),
                                                              arena=plan.arena)
        # each cached slab's host and arena codec ("auto" until init resolves it)
        self.host_precision: Dict[str, str] = {
            s: spec.arena.host_precision for s, spec in self.cached_slabs.items()}
        self.arena_precision: Dict[str, str] = {
            s: spec.arena.arena_precision for s, spec in self.cached_slabs.items()}
        self.precision_policy = PrecisionPolicy()
        # table -> (slab, offset of the table in the slab's concatenated vocab)
        self.table_slab: Dict[str, Tuple[str, int]] = {n: (n, 0) for n in self.device_slabs}
        for sname, spec in self.cached_slabs.items():
            for t, off in zip(spec.tables, spec.offsets):
                self.table_slab[t.name] = (sname, int(off))

    @classmethod
    def create(
        cls,
        tables: Sequence[TableConfig],
        budget_bytes: Optional[int] = None,
        counts: Optional[Mapping[str, np.ndarray]] = None,
        planner: Optional[PlacementPlanner] = None,
        **arena_kw,
    ) -> "EmbeddingCollection":
        """Plan and build.  Without a budget (or planner), the paper's layout:
        one shared cache arena over all tables.  With one, the planner's
        DEVICE / CACHED / GROUPED plan; ``arena_kw`` (``ArenaConfig``'s
        fields) sets the shared arena and the planner-wide codecs."""
        if planner is None and budget_bytes is None:
            return cls(tables, PlacementPlan.single_arena(tables, **arena_kw))
        planner = planner or PlacementPlanner(
            budget_bytes,
            arena=ArenaConfig(**arena_kw),
            host_precision=arena_kw.get("host_precision"),
            arena_precision=arena_kw.get("arena_precision"),
            arena_head_ratio=arena_kw.get("arena_head_ratio", 0.25),
        )
        return cls(tables, planner.plan(tables, counts=counts))

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
        host_precision: Optional[str] = None,
        arena_precision: Optional[str] = None,
    ) -> CollectionState:
        """Build the state: every table uniform(+-1/sqrt(dim)), drawn on
        ``device`` in chunks from ``seed + j`` for the j-th slab (DEVICE
        slabs first, then cached ones in plan order).  A DEVICE table stays
        on ``device``; a cached slab's rows are encoded by its host codec
        where they were drawn and land in its host table (pinned on a CUDA
        device), under an empty (or warmed) arena.

        ``host_precision`` / ``arena_precision`` override every cached
        slab's codecs for this state; "auto" asks ``PrecisionPolicy`` per
        slab from the counts (its no-stats pick without them).  The resolved
        codecs are recorded in ``self.host_precision`` /
        ``self.arena_precision`` (and the arena's in the slab spec, so every
        later cache config agrees with the state)."""
        dev = resolve_device(device)
        slabs: Dict[str, Union[DeviceSlab, CachedSlab]] = self._init_device_slabs(seed, dev)
        j = len(slabs)
        for sname, spec in list(self.cached_slabs.items()):
            c = slab_counts(spec, counts)
            spec, codec = self._resolve_codecs(sname, c, spec.capacity, spec.head_capacity,
                                               host_precision, arena_precision)
            full = HostStore.allocate({"weight": ((spec.vocab, spec.dim), spec.dtype)}, codec)
            for r0, chunk in draw_chunks(seed + j, spec.vocab, spec.dim, spec.dtype, dev):
                full.write_rows(r0, {"weight": chunk})
            if dev.type == "cuda":
                full.pin()
            j += 1
            idx_map = (torch.from_numpy(freq_lib.build_freq_stats(c).idx_map) if c is not None
                       else torch.arange(spec.vocab, dtype=torch.int32))
            ccfg = spec.cache_config()
            slab = CachedSlab(
                full=full,
                cache=cache_lib.init_cache(
                    ccfg, {"weight": torch.zeros((spec.dim,), dtype=spec.dtype)}, dev),
                idx_map=idx_map.to(dev),
            )
            if warm:
                slab = cached_slab_warmup(ccfg, slab)
            slabs[sname] = slab
        return CollectionState(slabs=slabs)

    def _init_device_slabs(self, seed: int, dev: torch.device) -> Dict[str, DeviceSlab]:
        """Each DEVICE table drawn whole on ``dev``, the j-th from ``seed + j``."""
        slabs = {}
        for j, (name, t) in enumerate(self.device_slabs.items()):
            weight = torch.empty((t.vocab, t.dim), dtype=t.dtype, device=dev)
            for r0, chunk in draw_chunks(seed + j, t.vocab, t.dim, t.dtype, dev):
                weight[r0 : r0 + chunk.shape[0]] = chunk
            slabs[name] = DeviceSlab(weight=weight)
        return slabs

    def _resolve_codecs(
        self, sname: str, counts: Optional[np.ndarray], capacity: int, head_capacity: int,
        host_precision: Optional[str], arena_precision: Optional[str],
    ) -> Tuple["_CachedSlabSpec", str]:
        """Slab ``sname``'s host and arena codecs ("auto": ``PrecisionPolicy``
        on the slab's vocab and the given resident ``capacity`` / fp32
        ``head_capacity``), recorded in ``self.host_precision`` /
        ``self.arena_precision`` and the slab spec.  Returns (spec, host codec)."""
        spec = self.cached_slabs[sname]
        geom = SlabGeometry(name=sname, vocab=spec.vocab, dim=spec.dim, capacity=capacity,
                            dtype_itemsize=spec.dtype.itemsize)
        codec = host_precision or spec.arena.host_precision
        if codec == "auto":
            codec = self.precision_policy.choose(geom, counts=counts)
        get_codec(codec)  # fail fast on typos
        self.host_precision[sname] = codec
        arena_codec = arena_precision or spec.arena.arena_precision
        if arena_codec == "auto":
            arena_codec = self.precision_policy.choose_arena(geom, head_capacity, counts=counts)
        get_codec(arena_codec)
        if arena_codec != spec.arena.arena_precision:
            spec = dataclasses.replace(
                spec, arena=dataclasses.replace(spec.arena, arena_precision=arena_codec))
            self.cached_slabs[sname] = spec
        self.arena_precision[sname] = arena_codec
        return spec, codec

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

    def _check_features(self, *fbs: FeatureBatch) -> None:
        for b in fbs:
            for f in b.features:
                if f not in self.feature_to_table:
                    raise KeyError(f"unknown feature {f!r}; known: {sorted(self.feature_to_table)}")

    def _device_addresses(self, fbs: Sequence[FeatureBatch]) -> List[Dict[str, torch.Tensor]]:
        """A DEVICE feature's address is its row id, for each batch."""
        return [{f: b.ids[f].to(torch.int32) for f in b.features
                 if self.feature_to_table[f] in self.device_slabs} for b in fbs]

    def plan_prepare(
        self,
        state: CollectionState,
        fb: FeatureBatch,
        fb_future: Sequence[FeatureBatch] = (),
        writeback: bool = True,
    ) -> CollectionPlan:
        """Planning half of ``prepare``: a DEVICE feature's address is its
        row id; each cached slab gets one cache plan over all its lanes.
        Reads ids and index state only, never weights.

        ``fb_future`` is a lookahead window of later batches: their rows are
        merged into each slab's plan (loaded now, pinned against eviction;
        see ``cache.plan_prepare``), and the plan carries their addresses
        and ``future_unresident``.  A slab that only the window touches is
        not prefetched: its window lanes count as unresident."""
        self._check_features(fb, *fb_future)
        addresses, *future_addresses = self._device_addresses((fb, *fb_future))
        unresident = []
        slab_plans: Dict[str, cache_lib.CachePlan] = {}
        for sname, spec in self.cached_slabs.items():
            raw = self._slab_raw(fb, sname)
            fut_raws = [self._slab_raw(b, sname) for b in fb_future]
            if raw is None:
                unresident += [(r >= 0).sum() for r in fut_raws if r is not None]
                continue
            slab = state.slabs[sname]
            rows_fut = [None if r is None else _translate(slab, r) for r in fut_raws]
            fut_parts = [r for r in rows_fut if r is not None]
            future_rows = torch.cat(fut_parts) if fut_parts else None
            ccfg = spec.cache_config(ids_per_step=int(raw.shape[0]), writeback=writeback)
            plan = cache_lib.plan_prepare(ccfg, slab.cache, _translate(slab, raw),
                                          future_rows=future_rows)
            slab_plans[sname] = plan
            pos = 0
            for f, n in self._slab_lanes(fb, sname):
                addresses[f] = plan.slots[pos : pos + n].reshape(fb.ids[f].shape)
                pos += n
            for j, (b, rows_j) in enumerate(zip(fb_future, rows_fut)):
                if rows_j is None:
                    continue
                slots_j = take_fill(plan.row_to_slot, torch.where(rows_j >= 0, rows_j, 0), -1)
                slots_j = torch.where(rows_j >= 0, slots_j, -1)
                unresident.append(((rows_j >= 0) & (slots_j < 0)).sum())
                pos = 0
                for f, n in self._slab_lanes(b, sname):
                    future_addresses[j][f] = slots_j[pos : pos + n].reshape(b.ids[f].shape)
                    pos += n
        plan = CollectionPlan(slab_plans=slab_plans, addresses=addresses,
                              future_addresses=tuple(future_addresses), writeback=writeback)
        if unresident:
            plan.future_unresident = i32(torch.stack(unresident).sum())
        return plan

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
        """Make every requested row resident; return per-feature addresses
        (cache slots; a DEVICE table's row ids)."""
        p = self.plan_prepare(state, fb, writeback=writeback)
        return self.apply_plan(state, p), p.addresses

    def prepare_lookahead(
        self,
        state: CollectionState,
        fb_now: FeatureBatch,
        fb_future: Sequence[FeatureBatch],
        writeback: bool = True,
    ) -> Tuple[CollectionState, Dict[str, torch.Tensor]]:
        """``prepare`` with a lookahead window: ``fb_future``'s rows load
        before they miss and stay pinned until their step; ``fb_now`` is
        exact whatever the window (future loads are dropped first)."""
        p = self.plan_prepare(state, fb_now, fb_future=tuple(fb_future), writeback=writeback)
        return self.apply_plan(state, p), p.addresses

    # ----- read path --------------------------------------------------------

    def weights(self, state: CollectionState) -> Dict[str, torch.Tensor]:
        """The trainable fast-tier weights, keyed by slab: differentiate the
        loss w.r.t. this dict and feed the grads to ``apply_grads``.  A
        DEVICE slab gives its table; a tiered arena its full decoded
        ``[capacity, dim]`` view (the straight-through scheme of arXiv
        2010.11305)."""
        out = {name: state.slabs[name].weight for name in self.device_slabs}
        for sname in self.cached_slabs:
            cached = state.slabs[sname].cache.cached_rows
            out[sname] = (cached.decode_leaf("weight") if isinstance(cached, ArenaStore)
                          else cached["weight"])
        return out

    @contract(max_sort_size=0)
    def gather(
        self,
        weights: Mapping[str, torch.Tensor],
        addresses: Mapping[str, torch.Tensor],
        fb: FeatureBatch,
    ) -> Dict[str, torch.Tensor]:
        """feature -> rows of shape ``ids.shape + (dim,)``; -1 lanes are zero.

        One ``take_fill`` per slab over all its features' lanes: the
        backward builds ONE dense gradient per slab (not one per feature)
        and accumulates duplicate ids with ``index_add_``, which the card
        does with atomics (so its summation order is not fixed)."""
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

    @contract(in_place=("state",), int_counters=INT_COUNTERS, max_sort_size=0)
    def apply_grads(
        self, state: CollectionState, grads: Mapping[str, torch.Tensor], lr
    ) -> CollectionState:
        """Synchronous SGD on the fast tier (paper §2.2.3: resident rows are
        authoritative; the host tier catches up at eviction or flush), in
        place; a DEVICE table steps as a whole.  A tiered arena steps on its
        decoded view, then stores the head raw and re-encodes the tail (rows
        with a zero gradient re-encode to the identical payload)."""
        for name in self.device_slabs:
            state.slabs[name].weight.sub_(lr * grads[name])
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
        slabs = dict(state.slabs)
        for sname, spec in self.cached_slabs.items():
            slabs[sname] = cached_slab_flush(spec.cache_config(), slabs[sname])
        return CollectionState(slabs=slabs)

    # ----- adaptive frequency refresh ---------------------------------------

    def refresh(
        self,
        state: CollectionState,
        cfg: Optional[refresh_lib.RefreshConfig] = None,
        writeback: bool = True,
    ) -> Tuple[CollectionState, refresh_lib.RefreshReport]:
        """Re-rank every cached slab (a CACHED table, or the GROUPED arena)
        from its online decayed counters and apply the bounded incremental
        permutation (``core.refresh``).

        Host-side, between steps: run it only when no planned addresses are
        outstanding (the trainers call it between steps or pipeline groups,
        the serve engine between batches).  Pure reindexing:
        ``full_lookup`` / ``dense_reference`` / ``lookup`` give bitwise the
        same values just before and after the call with an fp32 host tier
        (an fp16 / int8 tier's swapped dirty rows pay one encode).  Pass
        ``writeback=False`` for read-only serve states.  The arena and the
        host tables are updated in place, so ``state`` must not be used
        again.  Returns the state and a ``RefreshReport``; the same counts
        accumulate in the state (``metrics()``: ``refresh_swaps`` /
        ``refresh_rows_moved``)."""
        cfg = cfg or refresh_lib.RefreshConfig()
        slabs = dict(state.slabs)
        report = refresh_lib.RefreshReport()
        for sname, spec in self.cached_slabs.items():
            slabs[sname], stats = refresh_lib.refresh_cached_slab(
                spec.cache_config(writeback=writeback), slabs[sname], cfg, writeback=writeback)
            report.add(sname, stats)
        return CollectionState(slabs=slabs), report

    def collect_counts_stream(self, stream, max_batches: Optional[int] = None
                              ) -> Dict[str, np.ndarray]:
        """Per-table counts off a ``Prefetcher`` / ``FeatureBatch`` stream,
        with this collection's feature -> table routing, for
        ``init(counts=...)``."""
        return freq_lib.collect_counts_stream(
            stream, self.feature_to_table, {t.name: t.vocab for t in self.tables.values()},
            max_batches=max_batches,
        )

    # ----- oracles / bulk reads ---------------------------------------------

    def full_lookup(self, state: CollectionState, table: str, local_ids: torch.Tensor
                    ) -> torch.Tensor:
        """Rows of ``table``'s local ids (any shape, -1 lanes zero) from its
        authoritative tier, past the cache bookkeeping (retrieval's
        candidate scan): a DEVICE table, or a cached slab's host table
        (decoded) through ``idx_map``; on the device of ``local_ids``."""
        sname, off = self.table_slab[table]
        slab = state.slabs[sname]
        if sname in self.device_slabs:
            return take_fill(slab.weight, local_ids.to(slab.weight.device), 0).to(local_ids.device)
        ids = local_ids.to(slab.idx_map.device)
        rows = _translate(slab, torch.where(ids >= 0, ids + off, -1)).cpu()
        return slab.full.decode_rows(rows)["weight"].to(local_ids.device)

    def dense_reference(self, state: CollectionState, fb: FeatureBatch) -> Dict[str, torch.Tensor]:
        """Rows read straight out of the authoritative tiers: the uncached
        oracle (exact for a read-only cache, or after a flush; with an
        encoded host tier it decodes what was flushed)."""
        return {f: self.full_lookup(state, self.feature_to_table[f], fb.ids[f])
                for f in fb.features}

    # ----- telemetry ----------------------------------------------------------

    def _slab_codec(self, sname: str) -> str:
        """Resolved host codec of a cached slab ("auto" before init: the
        policy's no-stats pick)."""
        name = self.host_precision[sname]
        return self.precision_policy.no_stats if name == "auto" else name

    def _slab_arena_codec(self, sname: str) -> str:
        """Resolved arena tail codec (the same "auto" fallback)."""
        name = self.arena_precision[sname]
        return self.precision_policy.no_stats if name == "auto" else name

    def device_bytes(self) -> Dict[str, object]:
        """Device-resident vs host-tier footprint under the plan: per slab,
        a DEVICE table whole, a cached slab's arena (fp32 head + encoded
        tail + sideband when tiered), its index maps and tracker; the host
        tier at its encoded size, and what the codecs saved on each side.
        The planner's budget bounds ``device_total``."""
        per_slab: Dict[str, int] = {n: t.full_bytes for n, t in self.device_slabs.items()}
        slow = slow_fp32 = fast_fp32 = fast_actual = 0
        for sname, spec in self.cached_slabs.items():
            item = spec.dtype.itemsize
            arena_codec = self._slab_arena_codec(sname)
            head = spec.capacity if arena_codec == "fp32" else spec.head_capacity
            w = tiered_arena_bytes(spec.capacity, head, spec.dim, spec.dtype, arena_codec)
            # slot_to_row, last_used, use_count; row_to_slot, idx_map, tracker (2)
            per_slab[sname] = w + spec.capacity * 4 * 3 + spec.vocab * 4 * 4
            fast_actual += w
            fast_fp32 += spec.capacity * spec.dim * item
            slow += spec.vocab * get_codec(self._slab_codec(sname)).row_bytes((spec.dim,),
                                                                              spec.dtype)
            slow_fp32 += spec.vocab * spec.dim * item
        return {
            "device_total": sum(per_slab.values()),
            "slow_tier_bytes": slow,
            "host_bytes_saved": slow_fp32 - slow,
            "arena_bytes_saved": fast_fp32 - fast_actual,
            "per_slab": per_slab,
            "budget_bytes": self.plan.budget_bytes,
        }

    @contract(int_counters=METRICS_INT_COUNTERS, max_sort_size=0)
    def metrics(self, state: CollectionState, writeback: bool = True) -> Dict[str, object]:
        """Cache telemetry over the cached slabs, as in the reference: int32
        cumulative counters per slab (reconstructed exactly by the obs hub),
        plus the float32 convenience scalars."""
        zero = torch.zeros((), dtype=torch.int32)  # 0-dim: joins device counters
        hits = misses = evictions = overflows = ref_swaps = ref_rows = zero
        win_h = win_m = wire = torch.zeros(())
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
            per["host_row_bytes"][sname] = torch.full(
                (), row_bytes, dtype=torch.int32, device=c.hits.device
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
