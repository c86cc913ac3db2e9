"""Smoke shapes: one small case for each registered entry point (port of
``repro.analysis.smoke``).

Importing this module imports every covered module, which fills the
contract registry.  :func:`build_cases` builds the cases for one device;
nothing is built when the module is imported.

* The geometry is the reference's :data:`GEOMETRY` (vocab 256, capacity
  128, dim 8, 16 ids, batch 32, tables (192, 96), 2 shards, ...), so every
  ``max_sort_size`` quoted in the reference holds unchanged.
* States are built by the port's own ``init`` paths on the given device
  (``"cpu"`` or ``"cuda"``; nothing falls back to the CPU), the host
  tables pinned on the card as the real paths pin them.
* The port runs eagerly and updates its tables in place, so a case cannot
  be reused: ``make_args()`` builds fresh arguments for each call.  Plans
  fed to an apply are real plans of the fresh state.
* ``advance(*args)`` is the step t -> t + 1 map of the arguments (run for
  the stable-signature check); ``in_place`` are the positions of the
  arguments that the contract's ``in_place`` names.

The cases reach every hand-written kernel on the card: the threshold
(``victim_topk``, ``plan_prepare``), the bucketize's route entry
(``shard_bucketize``) and its image entry (the same case), the
gather-decode and its encode entry (``arena_gather``), the bag, FM, and
flash attention by each of its three routes (bf16, fp32 d 8, fp32 d 160).
"""
from __future__ import annotations

import dataclasses
import resource
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.contracts import registry
from repro_torch.core import cache as cache_lib
from repro_torch.core import refresh as refresh_lib
from repro_torch.core import transmitter
from repro_torch.core.collection import EmbeddingCollection, FeatureBatch, TableConfig
from repro_torch.core.sharded import ShardedEmbeddingCollection
from repro_torch.dist import exchange
from repro_torch.kernels.cache_ops import ops as co_ops
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.fm_interaction import kernel as fm_kernel
from repro_torch.dist.mesh import HybridMesh
from repro_torch.models.dlrm import DLRM, DLRMConfig
from repro_torch.store.host_store import HostStore

__all__ = ["GEOMETRY", "SmokeCase", "build_cases", "registered_without_smoke"]

GEOMETRY = dict(
    vocab=256, capacity=128, dim=8, ids=16, buffer_rows=64,
    batch=32, tables=(192, 96), shards=2, swap_k=8, rep_k=16, routed_w=48,
)


@dataclasses.dataclass
class SmokeCase:
    """One entry point: ``fn(*make_args())`` with its static arguments bound."""

    name: str
    fn: Callable
    make_args: Callable[[], Tuple[Any, ...]]
    advance: Optional[Callable] = None
    in_place: Tuple[int, ...] = ()


def _own_pages(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` in whole pages of its own.  ``cudaHostRegister`` pins
    whole pages and refuses a page that a registered tensor already holds,
    which two small tensors of one store (an int8 payload and its sideband)
    would share."""
    page = resource.getpagesize()
    n = t.numel() * t.element_size()
    buf = torch.empty((n + 2 * page,), dtype=torch.uint8)
    off = -buf.data_ptr() % page
    return buf[off: off + n].view(t.dtype).view(t.shape).copy_(t)


def _host(rows: int, dev: torch.device, codec: str = "fp32", seed: int = 0) -> HostStore:
    """A ``[rows, dim]`` host table of seeded values, pinned on the card."""
    g = torch.Generator().manual_seed(seed)
    store = HostStore.create({"weight": torch.rand((rows, GEOMETRY["dim"]), generator=g) - 0.5},
                             codec)
    if dev.type == "cuda":
        store = dataclasses.replace(
            store, data={k: _own_pages(v) for k, v in store.data.items()},
            sideband={k: _own_pages(v) for k, v in store.sideband.items()})
        store.pin()
    return store


# -- cache ------------------------------------------------------------------


def _cache_cases(dev: torch.device) -> Dict[str, SmokeCase]:
    g = GEOMETRY
    # an int8 tiered arena and the bounded top-K plan, as the reference's
    # cases; the host tier is int8 too, so write-backs take the fused encode
    cfg = cache_lib.CacheConfig(
        vocab=g["vocab"], capacity=g["capacity"], ids_per_step=g["ids"],
        buffer_rows=g["buffer_rows"], arena_precision="int8", use_pallas_plan=True,
    )
    row = {"weight": torch.zeros((g["dim"],))}
    # half hits, half misses of a warm cache: the misses evict dirty rows
    rows = torch.arange(g["capacity"] - g["ids"] // 2, g["capacity"] + g["ids"] // 2,
                        dtype=torch.int32, device=dev)

    def warm():
        full = _host(g["vocab"], dev, "int8")
        return full, cache_lib.warmup(cfg, full, cache_lib.init_cache(cfg, row, dev))[1]

    def plan_args():
        full, state = warm()
        return full, state, rows

    def apply_args():
        full, state = warm()
        return full, state, cache_lib.plan_prepare(cfg, state, rows)

    def plan_advance(full, state, r):
        _, s2 = cache_lib.apply_plan(cfg, full, state, cache_lib.plan_prepare(cfg, state, r))
        return full, s2, r

    def apply_advance(full, state, plan):
        f2, s2 = cache_lib.apply_plan(cfg, full, state, plan)
        return f2, s2, cache_lib.plan_prepare(cfg, s2, rows)

    m = "repro_torch.core.cache"
    return {
        f"{m}.plan_prepare": SmokeCase(
            f"{m}.plan_prepare", lambda full, s, r: cache_lib.plan_prepare(cfg, s, r),
            plan_args, plan_advance),
        f"{m}.apply_plan": SmokeCase(
            f"{m}.apply_plan", lambda f, s, p: cache_lib.apply_plan(cfg, f, s, p),
            apply_args, apply_advance, in_place=(0, 1)),
        f"{m}.flush": SmokeCase(
            f"{m}.flush", lambda f, s: cache_lib.flush(cfg, f, s), warm,
            lambda f, s: cache_lib.flush(cfg, f, s), in_place=(0,)),
        f"{m}.warmup": SmokeCase(
            f"{m}.warmup", lambda f, s: cache_lib.warmup(cfg, f, s),
            lambda: (_host(g["vocab"], dev, "int8"), cache_lib.init_cache(cfg, row, dev)),
            lambda f, s: cache_lib.warmup(cfg, f, s), in_place=(1,)),
    }


# -- collection (unsharded + sharded) ---------------------------------------


def _toy_tables() -> Tuple[TableConfig, ...]:
    g = GEOMETRY
    return tuple(
        TableConfig(name=f"f{i}", vocab=v, dim=g["dim"], ids_per_step=g["batch"],
                    cache_ratio=0.5, buffer_rows=g["buffer_rows"])
        for i, v in enumerate(g["tables"])
    )


def _toy_fb(dev: torch.device, step: int = 0) -> FeatureBatch:
    g = GEOMETRY
    rng = np.random.default_rng(step)
    ids = np.stack([rng.integers(0, v, g["batch"]) for v in g["tables"]], 1).astype(np.int32)
    return FeatureBatch.from_onehot(tuple(f"f{i}" for i in range(len(g["tables"]))),
                                    torch.from_numpy(ids).to(dev))


def _grads(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: torch.full_like(w, 0.01) for k, w in weights.items()}


def _collection_cases(dev: torch.device) -> Dict[str, SmokeCase]:
    g = GEOMETRY
    # an fp16 tiered arena here (the cache and sharded cases take int8), so
    # both tail codecs are covered
    coll = EmbeddingCollection.create(_toy_tables(), cache_ratio=0.5,
                                      buffer_rows=g["buffer_rows"], arena_precision="fp16")
    fb = _toy_fb(dev)

    def state():
        return coll.init(0, device=dev)

    def gather_args():  # the state rides along, so that its host table is unpinned after
        s = state()
        s = coll.apply_plan(s, plan := coll.plan_prepare(s, fb))
        return s, coll.weights(s), plan.addresses, fb

    def grads_args():
        s = state()
        return s, _grads(coll.weights(s))

    m = "repro_torch.core.collection.EmbeddingCollection"
    return {
        f"{m}.gather": SmokeCase(f"{m}.gather", lambda s, w, a, f: coll.gather(w, a, f),
                                 gather_args),
        f"{m}.apply_grads": SmokeCase(
            f"{m}.apply_grads", lambda s, grd: coll.apply_grads(s, grd, 0.05), grads_args,
            lambda s, grd: (coll.apply_grads(s, grd, 0.05), grd), in_place=(0,)),
        f"{m}.metrics": SmokeCase(f"{m}.metrics", lambda s: coll.metrics(s),
                                  lambda: (state(),)),
    }


def _sharded(dev: torch.device) -> ShardedEmbeddingCollection:
    g = GEOMETRY
    # replication, the fp16 exchange codec, a bounded plan width (routed_w <
    # the 64-lane dedup width: the compaction path) and an int8 tiered arena
    return ShardedEmbeddingCollection.create(
        _toy_tables(), num_shards=g["shards"], cache_ratio=0.5, buffer_rows=g["buffer_rows"],
        replicate_top_k=g["rep_k"], exchange_codec="fp16", max_routed_per_shard=g["routed_w"],
        arena_precision="int8", use_pallas_plan=True,
    )


def _sharded_cases(dev: torch.device) -> Dict[str, SmokeCase]:
    scoll = _sharded(dev)
    fb = _toy_fb(dev)

    def state():
        return scoll.init(1, device=dev)

    def apply_args():
        s = state()
        return s, scoll.plan_prepare(s, fb)

    def gather_args():
        s, plan = apply_args()
        s = scoll.apply_plan(s, plan)
        return s, scoll.weights(s), plan.addresses, fb

    def grads_args():
        s = state()
        return s, _grads(scoll.weights(s))

    def plan_advance(s, f):
        return scoll.apply_plan(s, scoll.plan_prepare(s, f)), f

    def apply_advance(s, p):
        s2 = scoll.apply_plan(s, p)
        return s2, scoll.plan_prepare(s2, fb)

    m = "repro_torch.core.sharded.ShardedEmbeddingCollection"
    return {
        f"{m}.plan_prepare": SmokeCase(f"{m}.plan_prepare", scoll.plan_prepare,
                                       lambda: (state(), fb), plan_advance),
        f"{m}.apply_plan": SmokeCase(f"{m}.apply_plan", scoll.apply_plan, apply_args,
                                     apply_advance, in_place=(0,)),
        f"{m}.gather": SmokeCase(f"{m}.gather", lambda s, w, a, f: scoll.gather(w, a, f),
                                 gather_args),
        f"{m}.apply_grads": SmokeCase(
            f"{m}.apply_grads", lambda s, grd: scoll.apply_grads(s, grd, 0.05), grads_args,
            lambda s, grd: (scoll.apply_grads(s, grd, 0.05), grd), in_place=(0,)),
        f"{m}.metrics": SmokeCase(f"{m}.metrics", lambda s: scoll.metrics(s),
                                  lambda: (state(),)),
    }


# -- the exchange between ranks ---------------------------------------------


def _exchange_cases(dev: torch.device) -> Dict[str, SmokeCase]:
    """The two legs on a one-shard mesh with no process group (where each
    is the identity): the code a rank runs, without a collective.  A
    rank step's collectives are counted on the card by ``chip_smoke.py``'s
    census."""
    g = GEOMETRY
    mesh = HybridMesh.coordinate(1, 0)

    def slot_args():
        return torch.arange(-1, g["ids"] - 1, dtype=torch.int32, device=dev)[None], mesh

    def row_args():
        rng = np.random.default_rng(3)
        w = torch.from_numpy(rng.standard_normal((g["capacity"], g["dim"]), np.float32)).to(dev)
        idx = torch.arange(-1, g["ids"] - 1, dtype=torch.int32, device=dev) * 5
        return w, idx, 0, g["ids"], "int8", mesh  # the compact width

    m = "repro_torch.dist.exchange"
    return {f"{m}.slot_leg": SmokeCase(f"{m}.slot_leg", exchange.slot_leg, slot_args),
            f"{m}.row_leg": SmokeCase(f"{m}.row_leg", exchange.row_leg, row_args)}


# -- the trainer's compute step --------------------------------------------


def _compute_step_case(dev: torch.device) -> Dict[str, SmokeCase]:
    g = GEOMETRY
    model = DLRM(DLRMConfig(
        vocab_sizes=g["tables"], n_dense=4, embed_dim=g["dim"], bottom_mlp=(16, g["dim"]),
        top_mlp=(16,), batch_size=g["batch"], cache_ratio=0.5, buffer_rows=g["buffer_rows"],
    ))
    rng = np.random.default_rng(2)
    batch = {
        "dense": torch.from_numpy(rng.standard_normal((g["batch"], 4), np.float32)).to(dev),
        "sparse": torch.stack([t.reshape(-1) for t in _toy_fb(dev).ids.values()], 1),
        "label": torch.from_numpy((rng.random(g["batch"]) < 0.5).astype(np.float32)).to(dev),
    }

    def args():
        s = model.init(2, device=dev)
        s = model.apply_step(s, plan := model.plan_step(s, batch))
        return s, batch, plan.addresses

    def advance(s, b, a):
        return model.compute_step(s, b, a)[0], b, a

    key = "repro_torch.models.common.CollectionTrainStep.compute_step"
    return {key: SmokeCase(key, model.compute_step, args, advance, in_place=(0,))}


# -- refresh slab surgery ---------------------------------------------------


def _refresh_cases(dev: torch.device) -> Dict[str, SmokeCase]:
    g = GEOMETRY
    k, br = g["swap_k"], g["buffer_rows"]
    # an int8 tiered arena, so the surgery crosses the precision boundary
    cfg = cache_lib.CacheConfig(vocab=g["vocab"], capacity=g["capacity"],
                                ids_per_step=g["ids"], buffer_rows=br, arena_precision="int8")
    row = {"weight": torch.zeros((g["dim"],))}
    # hot ranks (resident after warm-up) swapped with cold ones
    a = np.arange(g["capacity"] - k, g["capacity"], dtype=np.int64)
    b = np.arange(g["vocab"] - k, g["vocab"], dtype=np.int64)

    def swap_args():
        full = _host(g["vocab"], dev, "int8")
        cache = cache_lib.warmup(cfg, full, cache_lib.init_cache(cfg, row, dev))[1]
        return full, cache, torch.arange(g["vocab"], dtype=torch.int32, device=dev), a, b

    def swaps(full, cache, idx_map, a_, b_):
        return refresh_lib.apply_swaps(full, cache, idx_map, a_, b_, buffer_rows=br,
                                       writeback=True)

    scoll = _sharded(dev)

    def slab():
        return scoll.init(3, device=dev).slabs["__shared__"]

    def sharded_args():
        sl = slab()
        owner, local = refresh_lib.homes(sl)
        n = owner.shape[0]  # ranks past the replicated head, hot swapped with cold
        sa = np.arange(g["rep_k"], g["rep_k"] + k, dtype=np.int64)
        sb = np.arange(n - k, n, dtype=np.int64)
        return sl.full, sl.cache, sl.idx_map, sl.rep, owner, local, sa, sb

    def swaps_sharded(full, cache, idx_map, rep, owner, local, a_, b_):
        return refresh_lib.apply_swaps_sharded(full, cache, idx_map, rep, owner, local, a_, b_,
                                               buffer_rows=br, writeback=True)

    def rebalance_args():
        sl = slab()
        n = int(np.prod(sl.full.data["weight"].shape[:2]))
        src = np.arange(n, dtype=np.int64)  # new flat home -> old: k homes trade places
        src[: 2 * k] = np.concatenate([src[k: 2 * k], src[:k]])
        return sl.full, sl.cache, src

    def rebalance(full, cache, src):
        return refresh_lib.apply_rebalance(full, cache, src, buffer_rows=br, writeback=True)

    m = "repro_torch.core.refresh"
    return {
        f"{m}.apply_swaps": SmokeCase(
            f"{m}.apply_swaps", swaps, swap_args,
            lambda *x: swaps(*x) + (x[3], x[4])),
        f"{m}.apply_swaps_sharded": SmokeCase(
            f"{m}.apply_swaps_sharded", swaps_sharded, sharded_args,
            lambda *x: swaps_sharded(*x) + x[4:]),
        f"{m}.apply_rebalance": SmokeCase(
            f"{m}.apply_rebalance", rebalance, rebalance_args,
            lambda *x: rebalance(*x) + (x[2],)),
    }


# -- kernel entries -----------------------------------------------------------


def _kernel_cases(dev: torch.device) -> Dict[str, SmokeCase]:
    g = GEOMETRY
    rng = np.random.default_rng(4)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def bag_args():
        ids = rng.integers(-1, 64, g["batch"]).astype(np.int32)
        seg = np.sort(rng.integers(0, 8, g["batch"])).astype(np.int32)
        return t(rng.standard_normal((64, g["dim"]), np.float32)), t(ids), t(seg)

    def flash_args():  # [B, S, H, D]: bf16 (tensor cores), fp32 d 8 (3xTF32), fp32 d 160 (SIMT)
        out = []
        for dtype, d in ((torch.bfloat16, g["dim"]), (torch.float32, g["dim"]),
                         (torch.float32, 160)):
            out += [t(rng.standard_normal((2, 16, 2, d), np.float32)).to(dtype)
                    for _ in range(3)]
        return tuple(out)

    def flash(*qkv):
        return tuple(fa_ops.flash_attention(*qkv[i: i + 3]) for i in range(0, 9, 3))

    def bucketize(rank, owner, local):
        out = co_ops.shard_bucketize(rank, owner, local, rep_k=g["rep_k"],
                                     num_shards=g["shards"], u=g["routed_w"])
        # the image entry on the routed lanes: the composition the fused entry replaced
        return out, co_ops.bucketize_impl(out[2], out[3], g["shards"])

    def bucketize_args():
        n = g["tables"][0]
        return (t(rng.integers(-1, n, g["routed_w"]).astype(np.int32)),
                t(rng.integers(0, g["shards"], n).astype(np.int32)),
                t(rng.integers(0, n // g["shards"], n).astype(np.int32)))

    def arena_args():
        return (t(rng.standard_normal((32, g["dim"]), np.float32)),
                t(rng.integers(-128, 128, (96, g["dim"])).astype(np.int8)),
                t(np.abs(rng.standard_normal((96, 2), np.float32))),
                t(rng.integers(-1, 130, g["ids"]).astype(np.int32)))

    def move_args():
        return (_host(g["vocab"], dev),
                {"weight": torch.zeros((g["capacity"], g["dim"]), device=dev)},
                t(rng.permutation(g["vocab"])[: g["ids"]].astype(np.int32)),
                t(np.arange(g["ids"], dtype=np.int32)), t(np.ones(g["ids"], bool)))

    m = "repro_torch.kernels"
    cases = {
        f"{m}.embedding_bag.ops.embedding_bag": (
            lambda tb, i, sg: eb_ops.embedding_bag(tb, i, sg, num_segments=8, combiner="sum",
                                                   max_bag=4), bag_args),
        f"{m}.fm_interaction.kernel.fm_interaction": (
            fm_kernel.fm_interaction,
            lambda: (t(rng.standard_normal((g["batch"] // 2, 4, g["dim"]), np.float32)),)),
        f"{m}.flash_attention.ops.flash_attention": (flash, flash_args),
        # key sized to the cache capacity, lanes to the unique buffer: the
        # max_sort_size=64 contracts quote exactly these shapes
        f"{m}.cache_ops.ops.victim_topk_impl": (
            lambda k: co_ops.victim_topk_impl(k, g["ids"]),
            lambda: (t(rng.integers(-2**31, 2**31 - 1, g["capacity"]).astype(np.int32)),)),
        f"{m}.cache_ops.ops.plan_image_impl": (
            lambda r, rs: co_ops.plan_image_impl(r, rs, g["ids"]),
            lambda: (t(rng.integers(0, g["vocab"], 4 * g["ids"]).astype(np.int32)),
                     torch.full((g["vocab"],), -1, dtype=torch.int32, device=dev))),
        f"{m}.cache_ops.ops.shard_bucketize": (bucketize, bucketize_args),
        f"{m}.cache_ops.ops.arena_gather_impl": (
            lambda h, tl, sb, sl: co_ops.arena_gather_impl(h, tl, sb, sl, "int8"), arena_args),
        f"{m}.cache_ops.ops.arena_gather_encode_impl": (
            lambda h, tl, sb, sl: co_ops.arena_gather_encode_impl(h, tl, sb, sl, "int8", "int8"),
            arena_args),
        "repro_torch.core.transmitter.move_rows": (
            lambda s, d, si, di, ac: transmitter.move_rows(
                s, d, si, di, ac, buffer_rows=g["buffer_rows"], src_chunk_rows=8),
            move_args),
    }
    return {k: SmokeCase(k, fn, make) for k, (fn, make) in cases.items()}


def build_cases(device="cpu") -> Dict[str, SmokeCase]:
    """Every smoke case on ``device``, keyed by registry name.  ``run``
    holds this against the registry: a registered entry with no smoke case
    is itself a violation."""
    dev = torch.device(device)
    cases: Dict[str, SmokeCase] = {}
    for part in (_cache_cases, _collection_cases, _sharded_cases, _exchange_cases,
                 _compute_step_case, _refresh_cases, _kernel_cases):
        cases.update(part(dev))
    return cases


def registered_without_smoke(device="cpu") -> Tuple[str, ...]:
    """The registered entries that :func:`build_cases` gives no case on
    ``device`` (sorted); the gate needs this empty."""
    return tuple(sorted(set(registry()) - set(build_cases(device))))
