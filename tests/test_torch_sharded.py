"""The port's hybrid-parallel sharded collection (``repro_torch.core.sharded``,
the single-card stacked layout) against the JAX package's, and the
reference's own sharding tests ported to it.

Parity tests start from the reference's state converted through
``repro_torch.convert`` and feed both packages the same numpy-seeded ids or
``data/synth.py`` batches; the reference runs eagerly on the CPU.

Tolerances: plans, addresses, routed lanes, cache index state and fp32
lookups bitwise (they are data movement); the tracker's float leaves and
``shard_imbalance`` (``exp2`` decay, summed over a shard) within
``torch_parity.TRACKER_RTOL``; DLRM losses against the JAX package within
rtol 1e-5 (torch and XLA reduce the matmuls in different orders); each
ported reference test keeps its own tolerance.  Within the port, sharded
fp32 losses equal the unsharded port's bitwise.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import TRACKER_RTOL, assert_tree_equal, jax_to_numpy

from repro.core import collection as jcol
from repro.core.sharded import ShardedEmbeddingCollection as JSharded
from repro.models.dlrm import DLRM as JDLRM
from repro.models.dlrm import DLRMConfig as JDLRMConfig
from repro_torch import convert
from repro_torch.core import collection as col
from repro_torch.core.collection import SHARED_ARENA
from repro_torch.core.sharded import ShardedEmbeddingCollection, ShardedSlab, flat_store
from repro_torch.data import synth
from repro_torch.models.dlrm import DLRM, DLRMConfig
from repro_torch.train import checkpoint as ckpt

ZIPF = 1e6 / (np.arange(1000, dtype=np.float64) + 1) ** 0.8


def small_tables(mod=col, dim=8, ids=16):
    kw = {"cache_ratio": 0.2} if mod is jcol else {}
    return [mod.TableConfig("big", vocab=512, dim=dim, ids_per_step=ids, **kw),
            mod.TableConfig("small", vocab=96, dim=dim, ids_per_step=ids, **kw)]


def one_table(vocab=128, ids=8):
    return [col.TableConfig("t", vocab=vocab, dim=8, ids_per_step=ids)]


def rand_ids(tables, n, seed):
    rng = np.random.default_rng(seed)
    return {t.name: rng.integers(-1, t.vocab, n).astype(np.int32) for t in tables}


def fb_of(ids):
    return col.FeatureBatch(ids={k: torch.from_numpy(np.asarray(v, np.int32))
                                 for k, v in ids.items()})


def jfb_of(ids):
    return jcol.FeatureBatch(ids={k: jnp.asarray(np.asarray(v, np.int32))
                                  for k, v in ids.items()})


def _counts(tables, seed=1):
    rng = np.random.default_rng(seed)
    return {t.name: rng.integers(0, 50, t.vocab) for t in tables}


def _equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --------------------------------------------------------------------------
# the planner's device-assignment pass
# --------------------------------------------------------------------------


@pytest.mark.parametrize("counts,S,K", [
    ("zipf", 4, 0), ("zipf", 4, 32), ("zipf", 3, 5), ("ints", 2, 8), ("none", 3, 4),
    ("none", 1, 0), ("zipf", 1, 16),
])
def test_assign_devices_matches_reference_bitwise(counts, S, K):
    c = {"zipf": ZIPF, "none": None,
         "ints": np.random.default_rng(0).integers(0, 9, 1000).astype(np.float64)}[counts]
    want = jcol.PlacementPlanner.assign_devices(1000, S, c, replicate_top_k=K)
    got = col.PlacementPlanner.assign_devices(1000, S, c, replicate_top_k=K)
    for f in ("owner", "local", "shard_rows", "shard_load"):
        w, g = getattr(want, f), getattr(got, f)
        assert w.dtype == g.dtype and np.array_equal(w, g), f
    assert got.rows_per_shard == want.rows_per_shard and got.replicate_top_k == K
    assert got.imbalance() == want.imbalance()


@pytest.mark.parametrize("with_counts", [True, False])
def test_collection_assign_equals_the_assignments_of_init(with_counts):
    """``assign`` places every cached slab as ``init`` does, drawing no
    state (a rank that takes its shard of a state drawn elsewhere)."""
    tables = small_tables()
    counts = _counts(tables) if with_counts else None
    drawn = ShardedEmbeddingCollection.create(tables, num_shards=3, replicate_top_k=4)
    drawn.init(0, counts=counts, device="cpu")
    got = ShardedEmbeddingCollection.create(tables, num_shards=3,
                                            replicate_top_k=4).assign(counts)
    assert got.keys() == drawn.assignments.keys() and got
    for name, want in drawn.assignments.items():
        for f in ("owner", "local", "shard_rows", "shard_load"):
            assert np.array_equal(getattr(got[name], f), getattr(want, f)), (name, f)
        assert got[name].imbalance() == want.imbalance()


def test_assign_devices_balances_expected_traffic():
    a = col.PlacementPlanner.assign_devices(1000, 4, ZIPF)
    assert a.owner.shape == (1000,) and a.local.shape == (1000,)
    assert a.shard_rows.max() <= a.rows_per_shard and a.shard_rows.sum() == 1000
    for s in range(4):
        np.testing.assert_array_equal(np.sort(a.local[a.owner == s]), np.arange(a.shard_rows[s]))
    assert a.imbalance() < 1.05, a.shard_load
    _equal(a.owner, col.PlacementPlanner.assign_devices(1000, 4, ZIPF).owner)


def test_assign_devices_round_robin_without_counts():
    a = col.PlacementPlanner.assign_devices(10, 3, None)
    np.testing.assert_array_equal(a.owner, np.arange(10) % 3)
    np.testing.assert_array_equal(a.local, np.arange(10) // 3)


def test_assign_devices_rejects_bad_shapes():
    with pytest.raises(ValueError):
        col.PlacementPlanner.assign_devices(10, 0)
    with pytest.raises(ValueError):
        col.PlacementPlanner.assign_devices(10, 2, np.ones(7))


def test_assign_devices_replicate_top_k_homes():
    a = col.PlacementPlanner.assign_devices(1000, 4, ZIPF, replicate_top_k=32)
    assert a.replicate_top_k == 32 and a.shard_rows.sum() == 1000
    for s in range(4):
        np.testing.assert_array_equal(np.sort(a.local[a.owner == s]), np.arange(a.shard_rows[s]))
    np.testing.assert_allclose(a.shard_load.sum(), ZIPF[32:].sum())
    assert a.imbalance() < 1.05
    b0 = col.PlacementPlanner.assign_devices(1000, 4, ZIPF)
    b1 = col.PlacementPlanner.assign_devices(1000, 4, ZIPF, replicate_top_k=0)
    _equal(b0.owner, b1.owner)
    _equal(b0.local, b1.local)


def test_assign_devices_replicate_without_counts_round_robin():
    a = col.PlacementPlanner.assign_devices(10, 3, None, replicate_top_k=4)
    seq = np.concatenate([np.arange(4, 10), np.arange(4)])
    np.testing.assert_array_equal(a.owner[seq], np.arange(10) % 3)
    np.testing.assert_array_equal(a.local[seq], np.arange(10) // 3)


# --------------------------------------------------------------------------
# the port against the JAX package, bitwise
# --------------------------------------------------------------------------


def _pair(S, K, **kw):
    """The reference's sharded collection and state, and the port's built
    from the same state through ``convert``."""
    kw = dict(cache_ratio=0.2, replicate_top_k=K, use_pallas_plan=True, **kw)
    jc = JSharded.create(small_tables(jcol), num_shards=S, **kw)
    js = jc.init(jax.random.PRNGKey(0), counts=_counts(small_tables()))
    tc = ShardedEmbeddingCollection.create(small_tables(), num_shards=S, **kw)
    return (jc, js), (tc, convert.collection_state_from_numpy(jax_to_numpy(js), "cpu"))


@pytest.mark.parametrize("S,K", [(1, 0), (1, 8), (2, 0), (2, 8), (4, 0), (4, 8)])
def test_sharded_lookup_matches_reference_bitwise(S, K):
    """Addresses, rows, the per-shard plans' index state and counters, the
    routed lanes and the replicated tracker, step by step; then metrics."""
    (jc, js), (tc, ts) = _pair(S, K)
    for i in range(3):
        ids = rand_ids(small_tables(), 16, 100 + i)
        js, ja, jr = jc.lookup(js, jfb_of(ids))
        ts, ta, tr = tc.lookup(ts, fb_of(ids))
        for f in ids:
            _equal(ja[f], ta[f])
            assert np.array_equal(np.asarray(jr[f]), tr[f].numpy()), (i, f)
        want, got = jax_to_numpy(js), convert.to_numpy(ts)
        assert_tree_equal(want, got)  # every stacked cache leaf, routed_lanes, rep
    slab = ts.slabs[SHARED_ARENA]
    assert isinstance(slab, ShardedSlab) and slab.cache.hits.shape == (S,)
    assert int(slab.rep.step) == 3 and slab.rep.rows.shape == (K, 8)
    jm, tm = jc.metrics(js), tc.metrics(ts)
    for key in ("cache_misses", "cache_evictions", "uniq_overflows"):
        assert int(jm[key]) == int(tm[key]), key
    for key in ("exchange_routed_lanes", "exchange_lane_bytes", "slab_hits", "host_moved_rows"):
        assert int(jm[key][SHARED_ARENA]) == int(tm[key][SHARED_ARENA]), key
    _equal(jm["exchange_per_shard_lanes"], tm["exchange_per_shard_lanes"])
    for key in ("exchange_bytes", "shard_imbalance_routed", "hit_rate"):
        assert float(jm[key]) == float(tm[key]), key
    np.testing.assert_allclose(float(tm["shard_imbalance"]), float(jm["shard_imbalance"]),
                               rtol=TRACKER_RTOL)
    # after the flush the host tables match too (writeback=True lookups)
    assert_tree_equal(jax_to_numpy(jc.flush(js)), convert.to_numpy(tc.flush(ts)))


@pytest.mark.parametrize("fused", [False, True])
def test_router_pieces_match_reference(fused):
    """``_dedup`` / ``_route`` / ``_bucketize`` (and ``_route_image``) /
    ``_compact_lanes`` / ``_combine_slots`` bitwise on one live state,
    both dedup and image routes."""
    (jc, js), (tc, ts) = _pair(3, 8)
    jslab, tslab = js.slabs[SHARED_ARENA], ts.slabs[SHARED_ARENA]
    rng = np.random.default_rng(5)
    raw = rng.integers(-1, 608, 40).astype(np.int32)
    jrank = jc._rank_ids(jslab, jnp.asarray(raw))
    trank = tc._rank_ids(tslab, torch.from_numpy(raw))
    _equal(jrank, trank)
    ju, jp = JSharded._dedup(jrank, 608, fused=fused)
    tu, tp = ShardedEmbeddingCollection._dedup(trank, 608, fused=fused)
    _equal(ju, tu)
    _equal(jp, tp)
    jo, jl = jc._route(jslab, ju)
    to, tl = tc._route(tslab, tu)
    _equal(jo, to)
    _equal(jl, tl)
    _equal(jc._bucketize(jo, jl), tc._bucketize(to, tl))
    _equal(jc._bucketize(jo, jl, fused=fused), tc._route_image(tslab, tu, fused=fused))
    for width in (3, 9, 40):
        for w, g in zip(jc._compact_lanes(jo, jl, width), tc._compact_lanes(to, tl, width)):
            _equal(w, g)
    slots = rng.integers(-1, 20, (3, 40)).astype(np.int32)
    slots[:, rng.random(40) < 0.5] = -1
    slots[1:, :20] = -1  # at most one owner per lane
    slots[:1, 20:] = -1
    _equal(JSharded._combine_slots(jnp.asarray(slots), 20),
           ShardedEmbeddingCollection._combine_slots(torch.from_numpy(slots), 20))


@pytest.mark.parametrize("S,K", [(1, 0), (1, 8), (2, 0), (2, 8), (4, 0), (4, 8)])
def test_route_bucketize_matches_reference_route_and_bucketize(S, K):
    """The router's fused route + image entry (its plain route on the CPU)
    bitwise the reference's ``_route`` then ``_bucketize`` on converted
    slab state: a batch's dedup'd ranks (U = 41, not a multiple of 4),
    ranks at and past the tables' ends, every lane padding, every lane
    replicated; the image-only entry; and ``_route_image`` by both
    routes."""
    from repro_torch.kernels.cache_ops import kernel
    from repro_torch.kernels.cache_ops.ops import PAD_RANK

    (jc, js), (tc, ts) = _pair(S, K)
    jslab, tslab = js.slabs[SHARED_ARENA], ts.slabs[SHARED_ARENA]
    n = int(tslab.rank_owner.shape[0])
    rng = np.random.default_rng(S * 10 + K)
    raw = rng.integers(-1, 608, 41).astype(np.int32)
    uniq = np.array(JSharded._dedup(jc._rank_ids(jslab, jnp.asarray(raw)), 608, fused=True)[0])
    cases = {"batch": uniq,
             "table ends": np.array([0, K, n - 1, n, n + 5, PAD_RANK, -1], np.int32),
             "padding": np.full((9,), PAD_RANK, np.int32)}
    if K:
        cases["replicated"] = np.arange(K, dtype=np.int32)
    for name, u in cases.items():
        jo, jl = jc._route(jslab, jnp.asarray(u))
        want = (jo, jl, jc._bucketize(jo, jl, fused=True))
        got = kernel.route_bucketize(torch.from_numpy(u), tslab.rank_owner, tslab.rank_local,
                                     K, S)
        got += (kernel.route_image(torch.from_numpy(u), tslab.rank_owner, tslab.rank_local,
                                   K, S),)
        for w, g, part in zip(want + want[2:], got, ("owner", "local", "image", "image alone")):
            w = np.asarray(w)
            assert w.dtype == g.numpy().dtype and np.array_equal(w, g.numpy()), (name, part)
        for fused in (False, True):
            assert torch.equal(tc._route_image(tslab, torch.from_numpy(u), fused=fused), got[2])
        if name in ("padding", "replicated"):
            assert bool((got[2] == -1).all()), name


@pytest.mark.parametrize("codec", ["fp16", "int8"])
def test_encoded_exchange_matches_reference_bitwise(codec):
    """The port encodes only the gathered rows; row-wise codecs make that
    the reference's whole-arena encode restricted to them, bitwise."""
    (jc, js), (tc, ts) = _pair(2, 8, exchange_codec=codec)
    for i in range(2):
        ids = rand_ids(small_tables(), 16, 700 + i)
        js, _, jr = jc.lookup(js, jfb_of(ids))
        ts, _, tr = tc.lookup(ts, fb_of(ids))
        for f in ids:
            assert np.array_equal(np.asarray(jr[f]), tr[f].numpy()), (codec, i, f)


def test_bounded_plan_width_matches_reference_bitwise():
    (jc, js), (tc, ts) = _pair(3, 8, max_routed_per_shard=24)
    for i in range(3):
        ids = rand_ids(small_tables(), 16, 700 + i)
        js, ja, jr = jc.lookup(js, jfb_of(ids))
        ts, ta, tr = tc.lookup(ts, fb_of(ids))
        for f in ids:
            _equal(ja[f], ta[f])
            _equal(jr[f], tr[f])
    assert_tree_equal(jax_to_numpy(js), convert.to_numpy(ts))


def test_shard_imbalance_matches_reference():
    (jc, js), (tc, ts) = _skew_pair()
    jm, tm = jc.metrics(js), tc.metrics(ts)
    np.testing.assert_allclose(float(tm["shard_imbalance"]), float(jm["shard_imbalance"]),
                               rtol=TRACKER_RTOL)
    assert float(tm["shard_imbalance_routed"]) == float(jm["shard_imbalance_routed"])
    _equal(jm["exchange_per_shard_lanes"], tm["exchange_per_shard_lanes"])


# --------------------------------------------------------------------------
# the reference's sharding tests, ported
# --------------------------------------------------------------------------


@pytest.mark.parametrize("num_shards", [1, 3, 4])
def test_sharded_lookup_matches_dense_reference_bitwise(num_shards):
    tables = small_tables()
    coll = ShardedEmbeddingCollection.create(tables, num_shards=num_shards, cache_ratio=0.2)
    state = coll.init(0, counts=_counts(tables), device="cpu")
    for i in range(10):
        fb = fb_of(rand_ids(tables, 16, 100 + i))
        state, addr, rows = coll.lookup(state, fb)
        ref = coll.dense_reference(coll.flush(state), fb)
        for f in fb.features:
            _equal(rows[f], ref[f])
            assert bool((addr[f][fb.ids[f] < 0] == -1).all())


def test_one_shard_is_bit_identical_to_unsharded_collection():
    """One shard is the unsharded collection, bit for bit: the same table
    from the same seed, the same addresses and gathers."""
    tables = small_tables()
    ref = col.EmbeddingCollection.create(tables, cache_ratio=0.2)
    sc = ShardedEmbeddingCollection.create(tables, num_shards=1, cache_ratio=0.2)
    counts = _counts(tables, seed=2)
    st_ref = ref.init(0, counts=counts, device="cpu")
    st_sh = sc.init(0, counts=counts, device="cpu")
    _equal(st_ref.slabs[SHARED_ARENA].full["weight"],
           flat_store(st_sh.slabs[SHARED_ARENA].full)["weight"])
    for i in range(6):
        fb = fb_of(rand_ids(tables, 16, 200 + i))
        st_ref, a_ref = ref.prepare(st_ref, fb)
        st_sh, a_sh = sc.prepare(st_sh, fb)
        r_ref = ref.gather(ref.weights(st_ref), a_ref, fb)
        r_sh = sc.gather(sc.weights(st_sh), a_sh, fb)
        for f in fb.features:
            _equal(a_ref[f], a_sh[f])
            _equal(r_ref[f], r_sh[f])
    # the residency is the unsharded one with a leading shard dim (hits
    # differ: a shard's plan sees the dedup'd lanes, not every lane)
    want, got = st_ref.slabs[SHARED_ARENA].cache, st_sh.slabs[SHARED_ARENA].cache
    for f in ("slot_to_row", "row_to_slot", "last_used", "use_count", "misses", "evictions"):
        _equal(getattr(want, f), getattr(got, f)[0])
    _equal(want.cached_rows["weight"], got.cached_rows["weight"][0])


def test_sharded_init_is_the_unsharded_table_at_every_shard_count():
    tables = small_tables()
    counts = _counts(tables)
    ref = col.EmbeddingCollection.create(tables, cache_ratio=0.2).init(0, counts, device="cpu")
    probe = fb_of({t.name: np.arange(-1, t.vocab) for t in tables})
    want = col.EmbeddingCollection.create(tables, cache_ratio=0.2).dense_reference(ref, probe)
    for S, K in ((2, 0), (3, 7), (4, 64)):
        sc = ShardedEmbeddingCollection.create(tables, num_shards=S, cache_ratio=0.2,
                                               replicate_top_k=K)
        got = sc.dense_reference(sc.init(0, counts, device="cpu"), probe)
        for f in want:
            _equal(want[f], got[f])


def _dlrm_losses(shards=0, k=0, steps=8, base=None, batch=16, **kw):
    base = base or dict(vocab_sizes=(2048, 256, 64), embed_dim=8, cache_ratio=0.15, lr=0.2,
                        bottom_mlp=(16, 8), top_mlp=(16,))
    cfg = DLRMConfig(**base, batch_size=batch, model_shards=shards, replicate_top_k=k, **kw)
    model = DLRM(cfg)
    state = model.init(0, device="cpu")
    spec = synth.ZipfSparseSpec(vocab_sizes=cfg.vocab_sizes, n_dense=13)
    out = []
    for i in range(steps):
        b = {k_: torch.from_numpy(v) for k_, v in synth.sparse_batch(spec, batch, 0, i).items()}
        state, m = model.train_step(state, b)
        out.append(float(m["loss"]))
    return out


@pytest.mark.parametrize("num_shards", [1, 2, 4])
def test_sharded_dlrm_loss_trajectory_matches_single_device(num_shards):
    """fp32: the sharded losses equal the unsharded port's bit for bit."""
    assert _dlrm_losses(0) == _dlrm_losses(num_shards)


def test_replicated_dlrm_loss_bit_identical_fp32():
    ref = _dlrm_losses(0, 0)
    assert ref == _dlrm_losses(2, 8)
    assert ref == _dlrm_losses(4, 64)


def test_replicated_grads_match_unsharded_leaf_for_leaf():
    tables = small_tables()
    counts = _counts(tables, seed=5)
    ref = col.EmbeddingCollection.create(tables, cache_ratio=0.2)
    sc = ShardedEmbeddingCollection.create(tables, num_shards=2, cache_ratio=0.2,
                                           replicate_top_k=12)

    def sgd_steps(coll, n=5):
        state = coll.init(0, counts=counts, device="cpu")
        for i in range(n):
            fb = fb_of(rand_ids(tables, 16, 500 + i))
            state, addr = coll.prepare(state, fb)
            w = {k: v.detach().requires_grad_() for k, v in coll.weights(state).items()}
            rows = coll.gather(w, addr, fb)
            loss = sum(torch.sum(r * r) for r in rows.values())
            grads = dict(zip(w, torch.autograd.grad(loss, list(w.values()))))
            state = coll.apply_grads(state, grads, 0.1)
        return coll.flush(state)

    st_ref, st_sh = sgd_steps(ref), sgd_steps(sc)
    for t in tables:
        ids = torch.arange(t.vocab, dtype=torch.int32)
        _equal(ref.full_lookup(st_ref, t.name, ids), sc.full_lookup(st_sh, t.name, ids))


@pytest.mark.parametrize("num_shards", [1, 3])
def test_replicated_lookup_matches_dense_reference_bitwise(num_shards):
    tables = small_tables()
    coll = ShardedEmbeddingCollection.create(tables, num_shards=num_shards, cache_ratio=0.2,
                                             replicate_top_k=16)
    state = coll.init(0, counts=_counts(tables), device="cpu")
    for i in range(10):
        fb = fb_of(rand_ids(tables, 16, 100 + i))
        state, _, rows = coll.lookup(state, fb)
        ref = coll.dense_reference(coll.flush(state), fb)
        for f in fb.features:
            _equal(rows[f], ref[f])


def test_fully_replicated_slab_routes_zero_lanes():
    sc = ShardedEmbeddingCollection.create(one_table(), num_shards=2, cache_ratio=0.3,
                                           replicate_top_k=128)
    state = sc.init(0, device="cpu")
    for i in range(4):
        fb = fb_of(rand_ids(one_table(), 8, i))
        state, _, rows = sc.lookup(state, fb)
        _equal(rows["t"], sc.dense_reference(sc.flush(state), fb)["t"])
    m = sc.metrics(state)
    assert int(m["exchange_routed_lanes"][SHARED_ARENA]) == 0
    assert float(m["exchange_bytes"]) == 0.0


def test_exchange_telemetry_counts_valid_lanes():
    sc = ShardedEmbeddingCollection.create(one_table(), num_shards=2, cache_ratio=0.3)
    state = sc.init(0, device="cpu")
    fb = fb_of({"t": [1, 2, 3, -1, -1, 5, 6, -1]})
    state, _ = sc.prepare(state, fb)
    state, _ = sc.prepare(state, fb)
    m = sc.metrics(state)
    lanes = int(m["exchange_routed_lanes"][SHARED_ARENA])
    assert lanes == 2 * 5
    per_lane = int(m["exchange_lane_bytes"][SHARED_ARENA])
    assert per_lane == 4 + 8 * 4
    assert float(m["exchange_bytes"]) == lanes * per_lane


def test_dedup_routes_each_unique_id_once():
    sc = ShardedEmbeddingCollection.create(one_table(), num_shards=2, cache_ratio=0.3)
    state = sc.init(0, device="cpu")
    fb = fb_of({"t": [3, 3, 3, 7, -1, 7, 9, 3]})
    state, _, rows = sc.lookup(state, fb)
    state, _, _ = sc.lookup(state, fb)
    assert int(sc.metrics(state)["exchange_routed_lanes"][SHARED_ARENA]) == 2 * 3
    _equal(rows["t"], sc.dense_reference(sc.flush(state), fb)["t"])
    r = rows["t"]
    _equal(r[0], r[1])
    _equal(r[0], r[7])


def test_dedup_across_features_of_a_shared_arena():
    tables = [col.TableConfig("a", vocab=64, dim=8, ids_per_step=4),
              col.TableConfig("b", vocab=64, dim=8, ids_per_step=4)]
    sc = ShardedEmbeddingCollection.create(tables, num_shards=2, cache_ratio=0.4)
    state = sc.init(0, device="cpu")
    fb = fb_of({"a": [1, 1, 2, 2], "b": [1, 2, 2, -1]})
    state, _, rows = sc.lookup(state, fb)
    assert int(sc.metrics(state)["exchange_routed_lanes"][SHARED_ARENA]) == 4
    ref = sc.dense_reference(sc.flush(state), fb)
    for f in ("a", "b"):
        _equal(rows[f], ref[f])


def test_dedup_duplicate_heavy_training_stays_bit_identical():
    base = dict(vocab_sizes=(64, 16), embed_dim=8, cache_ratio=0.5, lr=0.2, bottom_mlp=(16, 8),
                top_mlp=(16,))
    assert _dlrm_losses(0, base=base, batch=32, steps=6) == \
        _dlrm_losses(2, base=base, batch=32, steps=6)


@pytest.mark.parametrize("codec,atol", [("fp16", 2e-3), ("int8", 5e-2)])
def test_encoded_exchange_gathers_allclose(codec, atol):
    tables = small_tables()
    sc = ShardedEmbeddingCollection.create(tables, num_shards=2, cache_ratio=0.2,
                                           exchange_codec=codec)
    state = sc.init(0, device="cpu")
    for i in range(6):
        fb = fb_of(rand_ids(tables, 16, 700 + i))
        state, _, rows = sc.lookup(state, fb)
        ref = sc.dense_reference(sc.flush(state), fb)
        for f in fb.features:
            np.testing.assert_allclose(rows[f].numpy(), ref[f].numpy(), atol=atol)


def test_exchange_codec_fp32_stays_bit_exact():
    tables = small_tables()
    a = ShardedEmbeddingCollection.create(tables, num_shards=2, cache_ratio=0.2)
    b = ShardedEmbeddingCollection.create(tables, num_shards=2, cache_ratio=0.2,
                                          exchange_codec="fp32")
    assert b.exchange_codec is None
    sa, sb = a.init(0, device="cpu"), b.init(0, device="cpu")
    for i in range(4):
        fb = fb_of(rand_ids(tables, 16, 800 + i))
        sa, _, ra = a.lookup(sa, fb)
        sb, _, rb = b.lookup(sb, fb)
        for f in fb.features:
            _equal(ra[f], rb[f])


@pytest.mark.parametrize("codec", ["fp16", "int8"])
def test_encoded_exchange_losses_allclose_to_unsharded(codec):
    base = dict(vocab_sizes=(1024, 128), embed_dim=8, cache_ratio=0.1, lr=0.2,
                bottom_mlp=(16, 8), top_mlp=(16,))
    np.testing.assert_allclose(_dlrm_losses(0, base=base),
                               _dlrm_losses(2, base=base, exchange_codec=codec), atol=5e-3)


def test_exchange_metrics_split_id_and_row_legs():
    sc = ShardedEmbeddingCollection.create(one_table(), num_shards=2, cache_ratio=0.3,
                                           exchange_codec="int8")
    state = sc.init(0, device="cpu")
    fb = fb_of({"t": [1, 2, 3, -1, -1, 5, 6, -1]})
    state, _ = sc.prepare(state, fb)
    state, _ = sc.prepare(state, fb)
    m = sc.metrics(state)
    lanes = int(m["exchange_routed_lanes"][SHARED_ARENA])
    assert lanes == 2 * 5
    id_b = int(m["exchange_id_lane_bytes"][SHARED_ARENA])
    row_b = int(m["exchange_row_lane_bytes"][SHARED_ARENA])
    assert id_b == 4 and row_b < 8 * 4
    assert int(m["exchange_lane_bytes"][SHARED_ARENA]) == id_b + row_b
    assert float(m["exchange_bytes"]) == lanes * (id_b + row_b)
    assert float(m["exchange_id_bytes"]) == lanes * id_b
    assert float(m["exchange_row_bytes"]) == lanes * row_b
    hist = m["exchange_per_shard_lanes"].numpy()
    assert hist.shape == (2,) and hist.sum() == lanes


def _skew_ids(i):
    return {"t": ((np.arange(16) * 2 + 2 * i) % 128).astype(np.int32)}


def _skew_collection():
    sc = ShardedEmbeddingCollection.create(one_table(ids=16), num_shards=2, cache_ratio=0.25)
    state = sc.init(0, device="cpu")  # no counts: rank == id, even ranks on shard 0
    for i in range(8):
        state, _ = sc.prepare(state, fb_of(_skew_ids(i)))
    return sc, state


def _skew_pair():
    jt = [jcol.TableConfig("t", vocab=128, dim=8, ids_per_step=16, cache_ratio=0.25)]
    jc = JSharded.create(jt, num_shards=2, cache_ratio=0.25)
    js = jc.init(jax.random.PRNGKey(0))
    tc = ShardedEmbeddingCollection.create(one_table(ids=16), num_shards=2, cache_ratio=0.25)
    ts = convert.collection_state_from_numpy(jax_to_numpy(js), "cpu")
    for i in range(8):
        js, _ = jc.prepare(js, jfb_of(_skew_ids(i)))
        ts, _ = tc.prepare(ts, fb_of(_skew_ids(i)))
    return (jc, js), (tc, ts)


def test_shard_imbalance_metric_is_live():
    sc, state = _skew_collection()
    m = sc.metrics(state)
    assert float(m["shard_imbalance"]) > 1.8
    assert float(m["shard_imbalance_routed"]) > 1.8
    hist = m["exchange_per_shard_lanes"].numpy()
    assert hist[0] > 0 and hist[1] == 0


def test_replicated_checkpoint_roundtrip_exact(tmp_path):
    tables = small_tables()
    sc = ShardedEmbeddingCollection.create(tables, num_shards=2, cache_ratio=0.2,
                                           replicate_top_k=16)
    state = sc.init(0, device="cpu")
    for i in range(3):
        state, _ = sc.prepare(state, fb_of(rand_ids(tables, 16, 900 + i)))
    state = sc.flush(state)
    ckpt.save(tmp_path, 5, {"emb": state})
    restored, step = ckpt.restore(tmp_path, {"emb": sc.init(1, device="cpu", warm=False)})
    assert step == 5
    assert_tree_equal(convert.to_numpy({"emb": state}), convert.to_numpy(restored))


def test_checkpoint_from_pre_replication_layout_fails_loudly(tmp_path):
    tables = small_tables()
    old = ShardedEmbeddingCollection.create(tables, num_shards=2, cache_ratio=0.2)
    ckpt.save(tmp_path, 3, {"emb": old.flush(old.init(0, device="cpu"))})
    new = ShardedEmbeddingCollection.create(tables, num_shards=2, cache_ratio=0.2,
                                            replicate_top_k=16)
    with pytest.raises(ValueError):
        ckpt.restore(tmp_path, {"emb": new.init(0, device="cpu", warm=False)})


def test_bounded_plan_width_stays_bit_identical():
    tables = small_tables()

    def mk(w):
        return ShardedEmbeddingCollection.create(tables, num_shards=3, cache_ratio=0.2,
                                                 replicate_top_k=8, max_routed_per_shard=w)

    counts = _counts(tables, seed=5)
    a, b = mk(0), mk(24)  # the dedup width is 2 * 16 = 32 lanes: 24 compacts
    sa, sb = a.init(0, counts=counts, device="cpu"), b.init(0, counts=counts, device="cpu")
    for i in range(8):
        fb = fb_of(rand_ids(tables, 16, 700 + i))
        sa, addr_a, rows_a = a.lookup(sa, fb)
        sb, addr_b, rows_b = b.lookup(sb, fb)
        for f in fb.features:
            _equal(addr_a[f], addr_b[f])
            _equal(rows_a[f], rows_b[f])
    ma, mb = a.metrics(sa), b.metrics(sb)
    assert int(mb["uniq_overflows"]) == 0
    _equal(ma["exchange_per_shard_lanes"], mb["exchange_per_shard_lanes"])


def test_bounded_plan_width_overflow_is_loud():
    sc = ShardedEmbeddingCollection.create(one_table(ids=16), num_shards=2, cache_ratio=0.5,
                                           max_routed_per_shard=3)
    state = sc.init(0, device="cpu")
    state, _ = sc.prepare(state, fb_of({"t": np.arange(0, 16, 2)}))
    assert int(sc.metrics(state)["uniq_overflows"]) == 5


@pytest.mark.parametrize("rep_k", [0, 8])
def test_sharded_tiered_post_flush_exact(rep_k):
    """An int8-tiered arena per shard, against the reference (lookups and
    every state leaf bitwise, both eager) and its own dense reference."""
    (jc, js), (tc, ts) = _pair(2, rep_k, arena_precision="int8")
    for i in range(3):
        ids = rand_ids(small_tables(), 16, 700 + i)
        js, _, jr = jc.lookup(js, jfb_of(ids))
        ts, _, tr = tc.lookup(ts, fb_of(ids))
        js = jc.flush(js)
        ref = tc.dense_reference(tc.flush(ts), fb_of(ids))
        for f in ids:
            _equal(tr[f], ref[f])
            _equal(jr[f], tr[f])
    assert_tree_equal(jax_to_numpy(js), convert.to_numpy(ts))
    m = tc.metrics(ts)
    assert m["slab_tier_promotions"][SHARED_ARENA].dtype == torch.int32
    assert m["slab_tier_demotions"][SHARED_ARENA].dtype == torch.int32


# --------------------------------------------------------------------------
# the lookahead window, the host codecs and the budget mode (sharded)
# --------------------------------------------------------------------------


def _plans_equal(jp, tp, path):
    """A sharded plan, its ``future_addresses`` tuple included."""
    want, got = jax_to_numpy(jp), convert.to_numpy(tp)
    wf, gf = want.pop("future_addresses"), got.pop("future_addresses")
    assert len(wf) == len(gf), path
    for j, (a, b) in enumerate(zip(wf, gf)):
        assert_tree_equal(jax_to_numpy(a), b, f"{path}/future{j}")
    assert_tree_equal(want, got, path)


@pytest.mark.parametrize("S,K,width", [(2, 0, 0), (2, 8, 0), (4, 8, 0), (3, 8, 24)])
def test_sharded_lookahead_plan_matches_reference(S, K, width):
    """``plan_prepare(fb_future=)`` per shard: the window's addresses
    (replicated lanes at their arena addresses), ``future_unresident``,
    every per-shard plan and the applied state bitwise, step by step; a
    width bound compacts the window's image too."""
    (jc, js), (tc, ts) = _pair(S, K, max_routed_per_shard=width)
    for i in range(3):
        now, window = rand_ids(small_tables(), 16, 40 + i), [
            rand_ids(small_tables(), 16, 50 + i), rand_ids(small_tables(), 16, 60 + i)]
        jp = jc.plan_prepare(js, jfb_of(now), fb_future=tuple(jfb_of(w) for w in window))
        tp = tc.plan_prepare(ts, fb_of(now), fb_future=tuple(fb_of(w) for w in window))
        _plans_equal(jp, tp, f"plan{i}")
        js, ts = jc.apply_plan(js, jp), tc.apply_plan(ts, tp)
        assert_tree_equal(jax_to_numpy(js), convert.to_numpy(ts), f"state{i}")
    if not width:  # a compacted window may drop a lane's pin (the reference's too)
        assert int(tp.future_unresident) == 0


def test_sharded_pipelined_trainer_bit_identical_to_serial():
    """Pipelined groups plan per shard: depth-2 groups on a 2-shard DLRM
    give the serial losses bit for bit, and the exchange telemetry stays
    exact ints."""
    from repro_torch.train.trainer import PipelinedTrainer, Trainer, TrainerConfig

    cfg = DLRMConfig(vocab_sizes=(1024, 128), embed_dim=8, batch_size=16, cache_ratio=0.25,
                     lr=0.1, bottom_mlp=(16, 8), top_mlp=(16,), model_shards=2)
    spec = synth.ZipfSparseSpec(vocab_sizes=cfg.vocab_sizes, n_dense=13)
    m1, m2 = DLRM(cfg), DLRM(cfg)
    kw = dict(make_batch=lambda s: synth.sparse_batch(spec, 16, 0, s), device="cpu")
    serial = Trainer(TrainerConfig(max_steps=6), init_fn=lambda: m1.init(0, device="cpu"),
                     step_fn=m1.train_step, flush_fn=m1.flush, **kw)
    piped = PipelinedTrainer(TrainerConfig(max_steps=6, pipeline_depth=2),
                             init_fn=lambda: m2.init(0, device="cpu"), plan_fn=m2.plan_step,
                             compute_fn=m2.compute_step, apply_fn=m2.apply_step,
                             flush_fn=m2.flush, **kw)
    serial.run()
    piped.run()
    assert [h["loss"] for h in serial.history] == [h["loss"] for h in piped.history]
    assert isinstance(serial.history[-1]["exchange_bytes"], int)


def test_sharded_int8_sideband_shards_with_payload():
    """The int8 host tier stacks ``[S, vs, dim]`` payload with its ``[S, vs,
    2]`` sideband, and each rank's pair is bitwise the unsharded port's
    encode of the same row (one table from one seed)."""
    tables = small_tables()
    counts = _counts(tables)
    sc = ShardedEmbeddingCollection.create(tables, num_shards=4, cache_ratio=0.2,
                                           host_precision="int8")
    state = sc.init(0, counts=counts, device="cpu")
    uc = col.EmbeddingCollection.create(tables, cache_ratio=0.2, host_precision="int8")
    ref = uc.init(0, counts=counts, device="cpu").slabs[SHARED_ARENA].full
    spec = sc.cached_slabs[SHARED_ARENA]
    vs = sc.rows_per_shard(spec)
    slab = state.slabs[SHARED_ARENA]
    store = slab.full
    assert store.data["weight"].shape == (4, vs, spec.dim)
    assert store.data["weight"].dtype == torch.int8
    assert store.sideband["weight"].shape == (4, vs, 2)
    home = (slab.rank_owner.long() * vs + slab.rank_local.long())
    flat = flat_store(store)
    _equal(flat.data["weight"][home], ref.data["weight"])
    _equal(flat.sideband["weight"][home], ref.sideband["weight"])
    dec = flat.decode_rows(home)["weight"]
    assert torch.isfinite(dec).all() and dec.shape == (spec.vocab, spec.dim)
    db = sc.device_bytes()
    assert db["slow_tier_bytes"] == 4 * vs * (spec.dim + 8)
    assert db["host_bytes_saved"] == 4 * vs * spec.dim * 4 - db["slow_tier_bytes"]


@pytest.mark.parametrize("codec", ["fp16", "int8"])
def test_sharded_quantized_evict_reload_payload_stable(codec):
    """Evict and reload through the per-shard transmitters: lookups track
    the host tier to codec noise, and untouched rows keep a bit-stable
    payload across more eviction cycles (sideband within 1e-6)."""
    tables = [col.TableConfig("t", vocab=256, dim=8, ids_per_step=8, cache_ratio=0.05)]
    sc = ShardedEmbeddingCollection.create(tables, num_shards=2, cache_ratio=0.05,
                                           host_precision=codec)
    state = sc.init(0, device="cpu")
    rng = np.random.default_rng(3)

    def churn(state, n):
        for _ in range(n):  # a tiny cache: constant eviction traffic
            fb = fb_of({"t": rng.integers(0, 256, 8)})
            state, addr = sc.prepare(state, fb)
            rows = sc.gather(sc.weights(state), addr, fb)
            ref = sc.dense_reference(sc.flush(state), fb)
            np.testing.assert_allclose(rows["t"].numpy(), ref["t"].numpy(), atol=1e-6)
        return state

    state = sc.flush(churn(state, 6))
    store = state.slabs[SHARED_ARENA].full
    pay0 = store.data["weight"].clone()
    side0 = store.sideband["weight"].clone() if store.sideband else None
    state = sc.flush(churn(state, 6))
    _equal(pay0, store.data["weight"])
    if side0 is not None:
        np.testing.assert_allclose(side0.numpy(), store.sideband["weight"].numpy(), atol=1e-6)
    assert int(sc.metrics(state)["cache_evictions"]) > 0


def test_sharded_one_shard_int8_bit_identical_to_unsharded():
    base = dict(vocab_sizes=(1024, 128), embed_dim=8, cache_ratio=0.1, lr=0.2,
                bottom_mlp=(16, 8), top_mlp=(16,), host_precision="int8")
    assert _dlrm_losses(0, steps=6, base=base) == _dlrm_losses(1, steps=6, base=base)


def test_sharded_int8_losses_allclose_to_unsharded():
    """Per-shard eviction schedules requantize different rows: codec noise."""
    base = dict(vocab_sizes=(1024, 128), embed_dim=8, cache_ratio=0.1, lr=0.2,
                bottom_mlp=(16, 8), top_mlp=(16,), host_precision="int8")
    np.testing.assert_allclose(_dlrm_losses(0, base=base), _dlrm_losses(4, base=base), atol=5e-3)


def test_sharded_int8_checkpoint_roundtrip_exact(tmp_path):
    """The encoded stacked store (payload and sideband) persists and
    restores exactly."""
    tables = small_tables()
    sc = ShardedEmbeddingCollection.create(tables, num_shards=4, cache_ratio=0.2,
                                           host_precision="int8")
    state = sc.init(0, device="cpu")
    for i in range(4):
        state, _ = sc.prepare(state, fb_of(rand_ids(tables, 16, 300 + i)))
    state = sc.flush(state)
    ckpt.save(tmp_path, 7, {"emb": state})
    restored, step = ckpt.restore(tmp_path, {"emb": sc.init(1, device="cpu", warm=False)})
    assert step == 7
    assert_tree_equal(convert.to_numpy({"emb": state}), convert.to_numpy(restored))


def test_device_budget_mode_composes_with_sharding():
    """A budget plan (DEVICE + CACHED) shards only the cached slab; the
    DEVICE table stays whole and the lookups stay exact."""
    tables = [col.TableConfig("big", vocab=4096, dim=8, ids_per_step=16, cache_ratio=0.1),
              col.TableConfig("hot", vocab=64, dim=8, ids_per_step=16)]
    sc = ShardedEmbeddingCollection.create(tables, num_shards=2, budget_bytes=80_000)
    assert sc.device_slabs and sc.cached_slabs
    state = sc.init(0, device="cpu")
    assert isinstance(state.slabs["big"], ShardedSlab)
    assert state.slabs["hot"].weight.shape == (64, 8)
    fb = fb_of(rand_ids(tables, 16, 4))
    state, _, rows = sc.lookup(state, fb)
    ref = sc.dense_reference(sc.flush(state), fb)
    for f in fb.features:
        _equal(rows[f], ref[f])
    db = sc.device_bytes()
    assert db["budget_bytes"] == 80_000 and db["per_slab"]["hot"] == 64 * 8 * 4


@pytest.mark.parametrize("host", ["fp32", "int8"])
def test_sharded_budget_mode_matches_reference(host):
    """The sharded budget plan from the converted reference state, an
    encoded host tier and int8 arenas: placements, every lookup, the state
    after each step and the flushed host tier bitwise (eager, one
    transmitter round)."""
    def tables(mod):
        return [mod.TableConfig("big", vocab=4096, dim=8, ids_per_step=16, cache_ratio=0.1),
                mod.TableConfig("mid", vocab=1024, dim=8, ids_per_step=16, cache_ratio=0.1),
                mod.TableConfig("hot", vocab=64, dim=8, ids_per_step=16)]
    kw = dict(num_shards=2, budget_bytes=90_000, host_precision=host, arena_precision="int8",
              replicate_top_k=8)
    jc = JSharded.create(tables(jcol), **kw)
    tc = ShardedEmbeddingCollection.create(tables(col), **kw)
    assert jc.plan.summary() == tc.plan.summary()
    assert set(tc.device_slabs) == {"hot"} and set(tc.cached_slabs) == {"big", "mid"}
    js = jc.init(jax.random.PRNGKey(0))
    ts = convert.collection_state_from_numpy(jax_to_numpy(js), "cpu", collection=tc)
    for i in range(3):
        ids = rand_ids(tables(col), 16, 500 + i)
        js, ja, jr = jc.lookup(js, jfb_of(ids))
        ts, ta, tr = tc.lookup(ts, fb_of(ids))
        for f in ids:
            _equal(ja[f], ta[f])
            _equal(jr[f], tr[f])
        assert_tree_equal(jax_to_numpy(js), convert.to_numpy(ts), f"state{i}")
    assert_tree_equal(jax_to_numpy(jc.flush(js)), convert.to_numpy(tc.flush(ts)))
    jb, tb = jc.device_bytes(), tc.device_bytes()
    for key in ("device_total", "device_per_shard", "slow_tier_bytes", "host_bytes_saved",
                "arena_bytes_saved", "budget_bytes"):
        assert jb[key] == tb[key], key


# --------------------------------------------------------------------------
# the sharded DLRM: against the JAX package, the exchange count, unported
# --------------------------------------------------------------------------

VOCABS = (128, 64, 256)
SHAPE = dict(vocab_sizes=VOCABS, n_dense=13, embed_dim=16, batch_size=16, cache_ratio=0.25,
             lr=0.1, bottom_mlp=(32, 16), top_mlp=(32, 16), buffer_rows=24,
             use_pallas_plan=True)


@pytest.mark.parametrize("S,K,precision", [(2, 8, "fp32"), (4, 0, "fp32"), (2, 8, "int8")])
def test_sharded_train_step_matches_reference(S, K, precision):
    """Losses within rtol 1e-5; counters, routed lanes, per-shard cache index
    state and the replicated tracker's touches bitwise (they depend on the
    ids only)."""
    cfg = dict(SHAPE, model_shards=S, replicate_top_k=K, arena_precision=precision)
    jmodel, tmodel = JDLRM(JDLRMConfig(**cfg)), DLRM(DLRMConfig(**cfg))
    jstate = jmodel.init(jax.random.PRNGKey(0))
    tstate = convert.state_from_numpy(jax_to_numpy(jstate), device="cpu")
    jstep = jax.jit(jmodel.train_step)
    spec = synth.ZipfSparseSpec(vocab_sizes=VOCABS, n_dense=13)
    for step in range(4):
        b = synth.sparse_batch(spec, 16, 0, step)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tmodel.train_step(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5, atol=0)
        for key in ("cache_misses", "cache_evictions", "uniq_overflows"):
            assert int(tm[key]) == int(jm[key]), key
        for key in ("slab_hits", "exchange_routed_lanes"):
            assert int(tm[key][SHARED_ARENA]) == int(jm[key][SHARED_ARENA]), key
        _equal(jm["exchange_per_shard_lanes"], tm["exchange_per_shard_lanes"])
    want = jax_to_numpy(jstate)["emb"]["slabs"][SHARED_ARENA]
    got = convert.to_numpy(tstate)["emb"]["slabs"][SHARED_ARENA]
    assert_tree_equal(want["cache"], got["cache"], "cache", skip=("cached_rows",))
    for k in ("routed_lanes", "rank_owner", "rank_local"):
        _equal(want[k], got[k])
    _equal(want["rep"]["last_touch"], got["rep"]["last_touch"])
    _equal(want["rep"]["step"], got["rep"]["step"])
    np.testing.assert_allclose(got["rep"]["score"], want["rep"]["score"], rtol=TRACKER_RTOL)
    np.testing.assert_allclose(got["rep"]["rows"], want["rep"]["rows"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("S", [2, 4])
def test_exchange_bytes_match_bench_pr7(S):
    """BENCH_PR7's exchange payload at its own configuration: 278 652 B per
    step (8 444 B of ids, 270 208 B of rows) over batches 1-5 after batch
    0.  Dedup runs before the bucketize, so the count holds at any shard
    assignment."""
    vocabs, batch = (65536, 32768, 16384, 16384), 2048
    lanes = batch * len(vocabs)
    cfg = DLRMConfig(vocab_sizes=vocabs, embed_dim=32, batch_size=batch, cache_ratio=0.1, lr=0.5,
                     bottom_mlp=(64, 32), top_mlp=(64,), model_shards=S, replicate_top_k=2048,
                     max_routed_per_shard=2 * lanes // S if S >= 4 else 0)
    model = DLRM(cfg)
    coll = model.collection
    state = model.init(0, device="cpu")["emb"]
    spec = synth.ZipfSparseSpec(vocab_sizes=vocabs, n_dense=13)

    def prepare(i):
        b = synth.sparse_batch(spec, batch, 0, i)
        return coll.prepare(state, model.features({"sparse": torch.from_numpy(b["sparse"])}))[0]

    state = prepare(0)
    m0 = coll.metrics(state)
    for i in range(1, 6):
        state = prepare(i)
    m1 = coll.metrics(state)
    assert int(m1["uniq_overflows"]) == 0
    per_step = {k: (float(m1[k]) - float(m0[k])) / 5
                for k in ("exchange_bytes", "exchange_id_bytes", "exchange_row_bytes")}
    assert {k: round(v) for k, v in per_step.items()} == {
        "exchange_bytes": 278652, "exchange_id_bytes": 8444, "exchange_row_bytes": 270208}


def test_unported_sharded_surfaces_raise():
    """Invalid shard counts and exchange codecs raise; the refresh (ROADMAP
    item 11), the budget mode and the lookahead window (items 17 and 9) no
    longer do."""
    tables = small_tables()
    sc = ShardedEmbeddingCollection.create(tables, num_shards=2, cache_ratio=0.2)
    state = sc.init(0, device="cpu")
    state, report = sc.refresh(state)
    assert set(report.swaps) == set(sc.cached_slabs)
    with pytest.raises(ValueError):
        ShardedEmbeddingCollection.create(tables, num_shards=0)
    with pytest.raises(ValueError):
        ShardedEmbeddingCollection.create(tables, num_shards=2, exchange_codec="int4")


def test_sharded_trainer_checkpoint_resumes_exactly(tmp_path):
    """A sharded DLRM state (int8 tiers, a replicated head) round-trips
    through a trainer checkpoint: 4 steps, save, resume to 6 equals 6 in
    one run."""
    from repro_torch.train.trainer import Trainer, TrainerConfig

    model = DLRM(DLRMConfig(**dict(SHAPE, model_shards=2, replicate_top_k=8,
                                   arena_precision="int8")))
    spec = synth.ZipfSparseSpec(vocab_sizes=VOCABS, n_dense=13)

    def trainer(steps, ckpt_dir=None):
        return Trainer(TrainerConfig(max_steps=steps, ckpt_dir=ckpt_dir, ckpt_every=4),
                       init_fn=lambda: model.init(0, device="cpu"), step_fn=model.train_step,
                       make_batch=lambda s: synth.sparse_batch(spec, 16, 0, s),
                       flush_fn=model.flush, device="cpu")

    full = trainer(6)
    end = full.run()
    trainer(4, tmp_path).run()
    resumed = trainer(6, tmp_path)
    got = resumed.run()
    assert [h["step"] for h in resumed.history] == [4, 5]
    assert [h["loss"] for h in resumed.history] == [h["loss"] for h in full.history[4:]]
    assert_tree_equal(convert.to_numpy(model.flush(end)), convert.to_numpy(got))


def test_sharded_train_launcher_matches_reference_launcher(capsys, monkeypatch):
    """``launch/train.py --model-shards 2 --replicate-top-k 8`` on the CPU,
    from the reference launcher's initial state: the same hits, misses,
    host wire bytes and exchange bytes per step, losses within rtol 1e-5,
    and the same exchange line."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train

    runs = []

    class Recorded(jtrain.Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            runs.append(self)

    monkeypatch.setattr(jtrain, "Trainer", Recorded)
    argv = ["--arch", "dlrm-criteo", "--steps", "3", "--batch", "16", "--model-shards", "2",
            "--replicate-top-k", "8"]
    monkeypatch.setattr("sys.argv", ["train", *argv, "--use-pallas-plan"])
    jtrain.main()
    want_out = capsys.readouterr().out
    jcfg = JDLRMConfig(vocab_sizes=(100_000, 50_000, 20_000), embed_dim=32, batch_size=16,
                       cache_ratio=0.02, lr=0.3, bottom_mlp=(64, 32), top_mlp=(64,),
                       use_pallas_plan=True, model_shards=2, replicate_top_k=8)
    init = jax_to_numpy(JDLRM(jcfg).init(jax.random.PRNGKey(0)))
    monkeypatch.setattr(DLRM, "init", lambda self, seed, counts=None, device=None:
                        convert.state_from_numpy(init, device=device))
    got = train.main(["--device", "cpu", *argv])
    got_out = capsys.readouterr().out
    want = runs[0].history
    assert len(got.history) == len(want) == 3
    for g, w in zip(got.history, want):
        for key in ("cache_hits", "cache_misses", "host_wire_bytes", "exchange_routed_lanes",
                    "exchange_bytes", "exchange_id_bytes", "exchange_row_bytes"):
            assert g[key] == w[key], key
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5, atol=0)
        np.testing.assert_allclose(g["shard_imbalance"], w["shard_imbalance"], rtol=TRACKER_RTOL)
    assert got.history[-1]["exchange_bytes"] > 0
    for pattern in (r"cache hit rate: .*", r"hybrid parallel: .*"):
        assert re.search(pattern, got_out).group(0) == re.search(pattern, want_out).group(0)


def test_sharded_launcher_flags_need_model_shards():
    from repro_torch.launch import train

    with pytest.raises(SystemExit, match="model-shards"):
        train.main(["--device", "cpu", "--replicate-top-k", "8", "--steps", "1"])
    with pytest.raises(SystemExit, match="dlrm"):
        train.main(["--device", "cpu", "--arch", "fm", "--model-shards", "2", "--steps", "1"])
