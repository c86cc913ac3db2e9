"""CachedEmbedding, the paper's one-big-table design (port of
``repro.core.cached_embedding``).

Every per-field table is concatenated into one frequency-ordered table
(paper §5.1) and served through the two-tier software cache: the
all-GROUPED special case of ``core.collection``, one shared arena over
every table.  This module is a thin single-arena adapter over the
``collection.cached_slab_*`` ops (one slab, raw global ids); it is the
stable single-table API and the oracle of the bit-exactness tests.

The module is functional in form: a :class:`CachedEmbeddingState` is
threaded through the train step.  As everywhere in the port, the arena and
the host table are updated in place, so a state passed to a call must not
be used again.

Training protocol (synchronous updates, paper §2.2.3)::

    state, slots = prepare_ids(cfg, state, raw_ids)        # bookkeeping, no grad
    emb = gather_slots(state, slots)                       # grad w.r.t. the cached weight
    ... loss and backward give d(cached weight) ...
    state = apply_row_grads(cfg, state, grad_cached, lr)   # update the cached rows

Rows are authoritative while resident; eviction (inside ``prepare_ids``)
and :func:`flush_state` (the checkpoint barrier) write them back to the
host table.  On a CUDA device the host table is pinned in host memory and
the arena, the index maps, ``idx_map`` and ``offsets`` live on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import cache as cache_lib
from repro_torch.core import collection as coll_lib
from repro_torch.core import freq as freq_lib
from repro_torch.core.lanes import segment_sum, take_fill
from repro_torch.core.policies import Policy
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.store.codec import get_codec
from repro_torch.store.host_store import HostStore

__all__ = [
    "CachedEmbeddingConfig",
    "CachedEmbeddingState",
    "init_state",
    "globalize",
    "prepare_ids",
    "gather_slots",
    "embed_onehot",
    "embed_bag",
    "apply_row_grads",
    "flush_state",
    "dense_reference_lookup",
    "device_bytes",
]


@dataclasses.dataclass(frozen=True)
class CachedEmbeddingConfig:
    vocab_sizes: Tuple[int, ...]  # per-field vocab sizes (concatenated)
    dim: int
    ids_per_step: int  # flattened id count per prepare call
    cache_ratio: float = 0.015  # paper default 1.5 %
    buffer_rows: int = 65536
    policy: Policy = Policy.FREQ_LFU
    writeback: bool = True
    dtype: torch.dtype = torch.float32
    rowwise_adagrad: bool = False  # carry a per-row accumulator through the cache
    max_unique_per_step: int = 0  # 0 = worst case; see CacheConfig
    protect_via_inverse: bool = True  # see CacheConfig (paper isin = False)
    host_precision: str = "fp32"  # host-tier codec: fp32 (bit-exact) | fp16 | int8
    freq_half_life: int = 1024  # online frequency tracker decay (CacheConfig)
    use_pallas_plan: bool = False  # bounded top-K planning: the threshold kernel on the card
    chunk_rows: int = 0  # chunk-granularity host staging (CacheConfig)

    @property
    def vocab(self) -> int:
        return int(sum(self.vocab_sizes))

    @property
    def unique_size(self) -> int:
        k = min(self.ids_per_step, self.vocab)
        if self.max_unique_per_step:
            k = min(k, self.max_unique_per_step)
        return k

    @property
    def capacity(self) -> int:
        cap = max(int(self.cache_ratio * self.vocab), self.unique_size)
        return min(cap, self.vocab)

    def cache_config(self) -> cache_lib.CacheConfig:
        return cache_lib.CacheConfig(
            vocab=self.vocab,
            capacity=self.capacity,
            ids_per_step=self.ids_per_step,
            buffer_rows=self.buffer_rows,
            policy=self.policy,
            writeback=self.writeback,
            max_unique_per_step=self.max_unique_per_step,
            protect_via_inverse=self.protect_via_inverse,
            freq_half_life=self.freq_half_life,
            use_pallas_plan=self.use_pallas_plan,
            chunk_rows=self.chunk_rows,
        )


@dataclasses.dataclass
class CachedEmbeddingState:
    # the host tier: a HostStore of {"weight": [vocab, dim], ("accum": [vocab])?}
    # (the accumulators stay raw fp32 under every codec)
    full: HostStore
    cache: cache_lib.CacheState
    idx_map: torch.Tensor  # int32 [vocab] raw id -> freq-ranked row
    offsets: torch.Tensor  # int32 [fields] per-field base offset

    def slab(self) -> coll_lib.CachedSlab:
        """This state as the collection's single cached-arena slab."""
        return coll_lib.CachedSlab(full=self.full, cache=self.cache, idx_map=self.idx_map)

    def with_slab(self, slab: coll_lib.CachedSlab) -> "CachedEmbeddingState":
        return dataclasses.replace(self, full=slab.full, cache=slab.cache, idx_map=slab.idx_map)


def init_state(
    cfg: CachedEmbeddingConfig,
    seed: Union[int, torch.Generator] = 0,
    counts: Optional[np.ndarray] = None,
    warm: bool = True,
    device: DeviceLike = None,
) -> CachedEmbeddingState:
    """The frequency-ordered host table (uniform(+-1/sqrt(dim)) rows drawn
    on ``device`` in chunks from ``seed``, an int or a ``torch.Generator``
    on that device, encoded there by the host codec), ``idx_map`` from
    ``counts`` (the identity without them) and an empty, or warmed, cache.
    ``device`` is the CUDA card unless told otherwise; there the table is
    pinned."""
    dev = resolve_device(device)
    vocab, dim = cfg.vocab, cfg.dim
    like = {"weight": ((vocab, dim), cfg.dtype)}
    row_example = {"weight": torch.zeros((dim,), dtype=cfg.dtype)}
    if cfg.rowwise_adagrad:
        like["accum"] = ((vocab,), torch.float32)
        row_example["accum"] = torch.zeros((), dtype=torch.float32)
    full = HostStore.allocate(like, cfg.host_precision)
    for r0, chunk in coll_lib.draw_chunks(seed, vocab, dim, cfg.dtype, dev):
        full.write_rows(r0, {"weight": chunk})
    if cfg.rowwise_adagrad:
        full.data["accum"].zero_()
    if dev.type == "cuda":
        full.pin()
    idx_map = (freq_lib.build_freq_stats(counts).idx_map if counts is not None
               else np.arange(vocab, dtype=np.int32))
    offsets = freq_lib.concat_table_offsets(cfg.vocab_sizes).astype(np.int32)
    st = CachedEmbeddingState(
        full=full,
        cache=cache_lib.init_cache(cfg.cache_config(), row_example, dev),
        idx_map=torch.from_numpy(idx_map).to(dev),
        offsets=torch.from_numpy(offsets).to(dev),
    )
    if warm:
        st = st.with_slab(coll_lib.cached_slab_warmup(cfg.cache_config(), st.slab()))
    return st


def globalize(state: CachedEmbeddingState, field_ids: torch.Tensor) -> torch.Tensor:
    """[.., fields] local ids -> global concatenated-table ids."""
    return (field_ids.to(torch.int32) + state.offsets).to(torch.int32)


def prepare_ids(
    cfg: CachedEmbeddingConfig, state: CachedEmbeddingState, raw_ids: torch.Tensor
) -> Tuple[CachedEmbeddingState, torch.Tensor]:
    """Make every row of ``raw_ids`` (int32 [ids_per_step] global ids, -1 =
    padding) resident; returns the state and each lane's cache slot.
    Bookkeeping (Algorithm 1): call it outside the gradient."""
    slab, slots = coll_lib.cached_slab_prepare(cfg.cache_config(), state.slab(), raw_ids)
    return state.with_slab(slab), slots


def gather_slots(state: CachedEmbeddingState, slots: torch.Tensor) -> torch.Tensor:
    """Differentiable gather from the cached weight (padding -> zero rows)."""
    return coll_lib.cached_slab_gather(state.slab(), slots)


def embed_onehot(
    cfg: CachedEmbeddingConfig, state: CachedEmbeddingState, field_ids: torch.Tensor
) -> Tuple[CachedEmbeddingState, torch.Tensor, torch.Tensor]:
    """One id per field (Criteo-style): [batch, fields] -> [batch, fields, dim].
    Returns (state', slots, embeddings); keep ``slots`` to scatter gradients."""
    b, f = field_ids.shape
    gids = globalize(state, field_ids).reshape(-1)
    state, slots = prepare_ids(cfg, state, gids)
    return state, slots, gather_slots(state, slots).reshape(b, f, cfg.dim)


def embed_bag(
    cfg: CachedEmbeddingConfig,
    state: CachedEmbeddingState,
    flat_ids: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    combiner: str = "sum",
) -> Tuple[CachedEmbeddingState, torch.Tensor, torch.Tensor]:
    """EmbeddingBag over ragged multi-hot bags through the cache: gather +
    segment sum, as the reference computes it (padding ids < 0 add zero
    rows; ``mean`` divides by each bag's count of real ids, at least 1)."""
    state, slots = prepare_ids(cfg, state, flat_ids)
    rows = gather_slots(state, slots)
    pooled = segment_sum(rows, segment_ids, num_segments)
    if combiner == "mean":
        cnt = segment_sum((flat_ids >= 0).to(rows.dtype), segment_ids, num_segments)
        pooled = pooled / torch.clamp_min(cnt, 1.0)[:, None]
    return state, slots, pooled


def apply_row_grads(
    cfg: CachedEmbeddingConfig,
    state: CachedEmbeddingState,
    grad_cached_weight: torch.Tensor,
    lr: float,
) -> CachedEmbeddingState:
    """Synchronous update of the cached rows, in place: SGD, or row-wise
    Adagrad (``accum += mean(g**2)`` a row, step ``lr / (sqrt(accum) +
    1e-10)``).  The host copy catches up at eviction or flush (paper: the
    resident rows are authoritative)."""
    cached = state.cache.cached_rows
    w = cached["weight"]
    if cfg.rowwise_adagrad:
        g2 = torch.mean(grad_cached_weight.to(torch.float32) ** 2, dim=-1)
        accum = cached["accum"].add_(g2)
        # XLA's sqrt and divide round correctly.  torch's vectorised CPU
        # sqrt does not (float64 and back does: double rounding is exact for
        # sqrt), and torch computes ``float / tensor`` as a reciprocal times
        # the float, so the numerator is a tensor
        root = torch.sqrt(accum.to(torch.float64)).to(torch.float32)
        scale = torch.as_tensor(lr, dtype=torch.float32) / (root + 1e-10)
        w.sub_((scale[:, None] * grad_cached_weight).to(w.dtype))
    else:
        w.sub_((lr * grad_cached_weight).to(w.dtype))
    return state


def flush_state(cfg: CachedEmbeddingConfig, state: CachedEmbeddingState) -> CachedEmbeddingState:
    """Checkpoint barrier: write every resident row back to the host table."""
    return state.with_slab(coll_lib.cached_slab_flush(cfg.cache_config(), state.slab()))


def dense_reference_lookup(state: CachedEmbeddingState, field_ids: torch.Tensor) -> torch.Tensor:
    """Oracle: the rows of ``field_ids`` read past the cache out of the host
    table (decoded when the tier is encoded; exact after a flush, or for a
    read-only cache), on the device of ``field_ids``."""
    rows = take_fill(state.idx_map, globalize(state, field_ids), -1)
    return coll_lib._read_full_rows(state.full, rows)


def device_bytes(cfg: CachedEmbeddingConfig) -> dict:
    """Fast-tier and slow-tier footprint (the paper's Figs. 7/8 memory
    accounting; the slow tier at its encoded, host-precision size)."""
    itemsize = torch.empty((), dtype=cfg.dtype).element_size()
    fast = cfg.capacity * cfg.dim * itemsize  # cached weight
    fast += cfg.capacity * 4 * 3  # slot_to_row, last_used, use_count
    # row_to_slot + idx_map + frequency-tracker score/last_touch (on device)
    fast += cfg.vocab * 4 * 4
    slow = cfg.vocab * get_codec(cfg.host_precision).row_bytes((cfg.dim,), cfg.dtype)
    if cfg.rowwise_adagrad:
        fast += cfg.capacity * 4
        slow += cfg.vocab * 4  # accumulators stay raw fp32 (per-row scalars)
    return {"fast_tier_bytes": fast, "slow_tier_bytes": slow}
