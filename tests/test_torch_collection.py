"""The port's placement planner and multi-slab ``EmbeddingCollection``
(``core/collection.py``: DEVICE, per-table CACHED and GROUPED slabs, the
budget mode) against ``repro.core.collection``.

Tolerances: placements, cache ratios (the same Python float), device bytes
and the counters are exact; every state, address and row that the eager
reference moves with one transmitter round is compared bitwise (fp32 rows
and index state; int8 / fp16 payload and sideband); the tracker's float
leaves within ``torch_parity.TRACKER_RTOL``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_tree_equal, jax_to_numpy

from repro.core import collection as jcol
from repro_torch import convert
from repro_torch.core import collection as col
from repro_torch.core.lanes import segment_sum


def small_tables(mod=col, dim=8, ids=16):
    return [
        mod.TableConfig("hot", vocab=64, dim=dim, ids_per_step=ids),
        mod.TableConfig("big", vocab=4096, dim=dim, ids_per_step=ids, cache_ratio=0.1),
        mod.TableConfig("tiny_a", vocab=24, dim=dim, ids_per_step=ids),
        mod.TableConfig("tiny_b", vocab=24, dim=dim, ids_per_step=ids),
    ]


def zipf_ids(tables, n, seed):
    rng = np.random.default_rng(seed)
    return {t.name: (rng.zipf(1.3, n) % t.vocab).astype(np.int32) for t in tables}


def tfb(ids):
    return col.FeatureBatch(ids={k: torch.from_numpy(v) for k, v in ids.items()})


def jfb(ids):
    return jcol.FeatureBatch(ids={k: jnp.asarray(v) for k, v in ids.items()})


def _plan_view(plan):
    return {n: (p.placement.value, p.cache_ratio, p.host_precision, p.arena_precision)
            for n, p in plan.placements.items()}


def mixed(budget=80_000, **planner_kw):
    tables = small_tables()
    plan = col.PlacementPlanner(budget, group_below_rows=32, **planner_kw).plan(tables)
    return tables, col.EmbeddingCollection(tables, plan)


# --------------------------------------------------------------------------
# the planner
# --------------------------------------------------------------------------


def test_planner_respects_budget_and_mixes_placements():
    tables, coll = mixed()
    placements = {n: p.placement for n, p in coll.plan.placements.items()}
    assert placements["hot"] is col.Placement.DEVICE
    assert placements["big"] is col.Placement.CACHED
    assert placements["tiny_a"] is placements["tiny_b"] is col.Placement.GROUPED
    assert coll.device_bytes()["device_total"] <= 80_000
    assert list(coll.cached_slabs) == ["big", col.SHARED_ARENA]


def test_planner_prefers_hot_tables_with_counts():
    tables = [col.TableConfig("a", vocab=256, dim=8, ids_per_step=16),
              col.TableConfig("b", vocab=256, dim=8, ids_per_step=16)]
    budget = 256 * 8 * 4 + col.PlacementPlanner(0)._fast_bytes(tables[0], 0.0) + 64
    counts = {"a": np.ones(256), "b": np.full(256, 1000)}
    plan = col.PlacementPlanner(budget).plan(tables, counts=counts)
    assert plan.placements["b"].placement is col.Placement.DEVICE
    assert plan.placements["a"].placement is col.Placement.CACHED


def test_planner_raises_when_budget_infeasible():
    with pytest.raises(ValueError, match="cannot hold"):
        col.PlacementPlanner(100).plan([col.TableConfig("t", vocab=1000, dim=64,
                                                        ids_per_step=512)])


def test_floor_scaled_ratio_zero_is_honored():
    t = col.TableConfig("big", vocab=100_000, dim=32, ids_per_step=256, cache_ratio=0.05)
    floor_budget = col.PlacementPlanner(0)._fast_bytes(t, 0.0)
    plan = col.PlacementPlanner(floor_budget).plan([t])
    assert plan.placements["big"].cache_ratio == 0.0
    coll = col.EmbeddingCollection([t], plan)
    assert coll.cached_slabs["big"].capacity == t.unique_size()
    assert coll.device_bytes()["device_total"] <= floor_budget


def test_explicit_placement_overrides_survive():
    tables = [
        col.TableConfig("pin_dev", vocab=32, dim=4, ids_per_step=8,
                        placement=col.Placement.DEVICE),
        col.TableConfig("pin_cache", vocab=32, dim=4, ids_per_step=8,
                        placement=col.Placement.CACHED, cache_ratio=0.5),
    ]
    plan = col.PlacementPlanner(10**9).plan(tables)
    assert plan.placements["pin_dev"].placement is col.Placement.DEVICE
    assert plan.placements["pin_cache"].placement is col.Placement.CACHED


def test_dlrm_budget_mode_keeps_max_unique_bound():
    from repro_torch.models.dlrm import DLRM, DLRMConfig

    cfg = DLRMConfig(vocab_sizes=(4096, 64), embed_dim=8, batch_size=16, cache_ratio=0.25,
                     max_unique_per_step=8, bottom_mlp=(8,), top_mlp=(8,),
                     device_budget_bytes=80_000)
    cached = list(DLRM(cfg).collection.cached_slabs.values())
    assert cached and all(s.arena.max_unique_per_step == 8 for s in cached)


@pytest.mark.parametrize("budget,codecs,with_counts", [
    (80_000, (None, None), False), (80_000, ("int8", "int8"), True),
    (70_000, ("fp16", "auto"), False), (300_000, ("auto", "fp16"), True),
    (45_000, ("int8", None), True), (60_000, (None, "int8"), False),
])
def test_planner_matches_reference(budget, codecs, with_counts):
    hp, ap = codecs
    counts = None
    if with_counts:
        rng = np.random.default_rng(budget)
        counts = {t.name: rng.zipf(1.2, t.vocab).astype(np.int64) for t in small_tables()}
    try:
        jplan = jcol.PlacementPlanner(budget, group_below_rows=32, host_precision=hp,
                                      arena_precision=ap).plan(small_tables(jcol), counts=counts)
    except ValueError as e:  # infeasible: both refuse, naming the same need
        with pytest.raises(ValueError) as got:
            col.PlacementPlanner(budget, group_below_rows=32, host_precision=hp,
                                 arena_precision=ap).plan(small_tables(), counts=counts)
        assert str(got.value) == str(e)
        return
    tplan = col.PlacementPlanner(budget, group_below_rows=32, host_precision=hp,
                                 arena_precision=ap).plan(small_tables(), counts=counts)
    assert _plan_view(tplan) == _plan_view(jplan)
    assert tplan.summary() == jplan.summary()
    assert tplan.budget_bytes == jplan.budget_bytes
    for f in ("cache_ratio", "host_precision", "arena_precision", "arena_head_ratio"):
        assert getattr(tplan.arena, f) == getattr(jplan.arena, f), f
    jc = jcol.EmbeddingCollection(small_tables(jcol), jplan)
    tc = col.EmbeddingCollection(small_tables(), tplan)
    assert tc.device_bytes() == jc.device_bytes()


CRITEO_CACHED = ["f2", "f3", "f11", "f15", "f20"]


@pytest.mark.parametrize("codec", ["int8", "fp32"])
def test_planner_at_full_criteo_width(codec):
    """The budget phase's plan at full Criteo width and vocabulary, by
    arithmetic alone (no table is allocated): at 1 GiB, 21 DEVICE tables
    and 5 CACHED ones, at ratio 0.015 with int8 host and arena codecs, and
    scaled to the reference's 0.01433... with fp32 ones."""
    from repro.configs.dlrm_criteo import CONFIG as JCONFIG
    from repro.models.dlrm import DLRM as JDLRM
    from repro_torch.configs.dlrm_criteo import CONFIG
    from repro_torch.models.dlrm import DLRM

    kw = dict(device_budget_bytes=1 << 30, host_precision=codec, arena_precision=codec,
              use_pallas_plan=True)
    jcoll = JDLRM(dataclasses.replace(JCONFIG, **kw)).collection
    tcoll = DLRM(dataclasses.replace(CONFIG, **kw)).collection
    assert _plan_view(tcoll.plan) == _plan_view(jcoll.plan)
    assert sorted(tcoll.cached_slabs, key=lambda n: int(n[1:])) == CRITEO_CACHED
    assert len(tcoll.device_slabs) == 21
    assert sum(t.vocab for t in tcoll.device_slabs.values()) == 569_296
    assert sum(s.vocab for s in tcoll.cached_slabs.values()) == 33_193_281
    ratios = {tcoll.plan.placements[n].cache_ratio for n in CRITEO_CACHED}
    if codec == "int8":
        assert ratios == {0.015}
    else:
        (r,) = ratios
        assert 0.01433 <= r < 0.01434
    db = tcoll.device_bytes()
    assert db == jcoll.device_bytes() and db["device_total"] <= 1 << 30
    assert db["budget_bytes"] == 1 << 30
    with pytest.raises(ValueError, match="cannot hold"):
        DLRM(dataclasses.replace(CONFIG, **dict(kw, device_budget_bytes=1 << 29)))


def test_single_arena_plan_is_paper_layout():
    tables = small_tables()
    coll = col.EmbeddingCollection.create(tables, cache_ratio=0.1)
    assert not coll.device_slabs and list(coll.cached_slabs) == [col.SHARED_ARENA]
    assert coll.cached_slabs[col.SHARED_ARENA].vocab == sum(t.vocab for t in tables)
    assert coll.device_bytes()["budget_bytes"] is None


# --------------------------------------------------------------------------
# the mixed plan: exactness, parity, gradients
# --------------------------------------------------------------------------


def test_mixed_plan_matches_dense_reference_bitwise():
    tables, coll = mixed()
    assert coll.device_slabs and coll.cached_slabs
    state = coll.init(0, device="cpu")
    for i in range(20):
        fb = tfb(zipf_ids(tables, 16, seed=i))
        state, _, rows = coll.lookup(state, fb)
        ref = coll.dense_reference(coll.flush(state), fb)
        for f in fb.features:
            assert torch.equal(rows[f], ref[f]), f


@pytest.mark.parametrize("codec", ["fp32", "int8", "fp16"])
def test_mixed_plan_matches_reference_bitwise(codec):
    """The same converted state and batches through both collections,
    eagerly: addresses, rows, the whole state after each step's prepare and
    SGD, the per-slab counters and wire bytes, then the flush."""
    kw = dict(group_below_rows=32, host_precision=codec,
              arena_precision=None if codec == "fp32" else codec)
    jc = jcol.EmbeddingCollection(small_tables(jcol),
                                  jcol.PlacementPlanner(80_000, **kw).plan(small_tables(jcol)))
    tc = col.EmbeddingCollection(small_tables(),
                                 col.PlacementPlanner(80_000, **kw).plan(small_tables()))
    js = jc.init(jax.random.PRNGKey(0))
    ts = convert.collection_state_from_numpy(jax_to_numpy(js), device="cpu", collection=tc)
    assert tc.host_precision == jc.host_precision
    assert tc.arena_precision == jc.arena_precision
    rng = np.random.default_rng(7)
    for i in range(8):
        ids = zipf_ids(small_tables(), 16, seed=100 + i)
        ids["big"][rng.random(16) < 0.2] = -1
        js, jaddr, jrows = jc.lookup(js, jfb(ids))
        ts, taddr, trows = tc.lookup(ts, tfb(ids))
        for f in ids:
            assert np.array_equal(taddr[f].numpy(), np.asarray(jaddr[f])), f
            assert np.array_equal(trows[f].numpy(), np.asarray(jrows[f])), f
        grads = {s: rng.normal(size=tuple(w.shape)).astype(np.float32)
                 for s, w in tc.weights(ts).items()}
        js = jc.apply_grads(js, {s: jnp.asarray(g) for s, g in grads.items()}, 0.05)
        ts = tc.apply_grads(ts, {s: torch.from_numpy(g) for s, g in grads.items()}, 0.05)
        assert_tree_equal(jax_to_numpy(js), convert.to_numpy(ts), f"step {i}")
        jm, tm = jc.metrics(js), tc.metrics(ts)
        for key in ("cache_misses", "cache_evictions", "uniq_overflows"):
            assert int(tm[key]) == int(jm[key]), key
        for key in ("host_moved_rows", "host_row_bytes", "slab_hits", "slab_misses"):
            assert {k: int(v) for k, v in tm[key].items()} == \
                {k: int(v) for k, v in jm[key].items()}, key
    assert int(tm["cache_evictions"]) > 0
    js, ts = jc.flush(js), tc.flush(ts)  # the port's flush writes its host tier in place
    assert_tree_equal(jax_to_numpy(js), convert.to_numpy(ts), "flushed")
    probe = {"hot": np.array([3, -1, 63], np.int32), "big": np.array([0, 4095, -1], np.int32)}
    for t, ids in probe.items():
        want = jc.full_lookup(js, t, jnp.asarray(ids))
        assert np.array_equal(tc.full_lookup(ts, t, torch.from_numpy(ids)).numpy(),
                              np.asarray(want)), t


def test_padding_lanes_give_zero_rows_everywhere():
    tables, coll = mixed()
    state = coll.init(0, device="cpu")
    fb = col.FeatureBatch(ids={t.name: torch.full((16,), -1, dtype=torch.int32) for t in tables})
    state, addr, rows = coll.lookup(state, fb)
    for f in fb.features:
        assert bool((addr[f] == -1).all()) and bool((rows[f] == 0).all())


def test_grads_reach_device_and_cached_tiers():
    tables, coll = mixed()
    state = coll.init(0, device="cpu")
    fb = tfb(zipf_ids(tables, 16, seed=0))
    state, addr = coll.prepare(state, fb)
    w = {k: v.detach().clone().requires_grad_() for k, v in coll.weights(state).items()}
    loss = sum(torch.sum(r**2) for r in coll.gather(w, addr, fb).values())
    grads = dict(zip(w, torch.autograd.grad(loss, list(w.values()))))
    assert any(float(grads[s].abs().max()) > 0 for s in coll.device_slabs)
    assert any(float(grads[s].abs().max()) > 0 for s in coll.cached_slabs)
    before = {k: v.clone() for k, v in coll.weights(state).items()}
    after = coll.weights(coll.apply_grads(state, grads, 0.1))
    for s in before:
        assert not torch.equal(before[s], after[s]), s


def test_uniq_overflow_counted_under_collection_api():
    tables = [col.TableConfig("t", vocab=100, dim=4, ids_per_step=16, max_unique_per_step=4,
                              cache_ratio=0.3, placement=col.Placement.CACHED)]
    coll = col.EmbeddingCollection(tables, col.PlacementPlanner(10**9).plan(tables))
    state = coll.init(0, device="cpu")
    state, _ = coll.prepare(state, tfb({"t": np.arange(16, dtype=np.int32)}))
    assert int(coll.metrics(state)["uniq_overflows"]) == 1
    state, _ = coll.prepare(state, tfb({"t": np.zeros(16, np.int32)}))
    assert int(coll.metrics(state)["uniq_overflows"]) == 1


def test_full_lookup_padding_is_zero_on_every_tier():
    tables, coll = mixed()
    state = coll.init(0, device="cpu")
    for t in ("hot", "big", "tiny_b"):
        rows = coll.full_lookup(state, t, torch.tensor([3, -1, 7, -1], dtype=torch.int32))
        assert bool((rows[[1, 3]] == 0).all()) and bool((rows[[0, 2]] != 0).any()), t


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_pool_over_the_mixed_plan(combiner):
    """Bag features of DEVICE, CACHED and GROUPED tables: the kernel route
    (one embedding-bag call per slab; its plain version on the CPU) equals
    the segment-sum route bitwise, and both equal the dense reference's
    rows pooled."""
    tables, coll = mixed()
    state = coll.init(0, device="cpu")
    rng = np.random.default_rng(2)
    bags = {}
    for t in tables:
        flat = (rng.zipf(1.3, 16) % t.vocab).astype(np.int32)
        flat[rng.random(16) < 0.2] = -1
        bags[t.name] = (torch.from_numpy(flat), torch.arange(4, dtype=torch.int32)
                        .repeat_interleave(4))
    fb = col.FeatureBatch.from_bags(bags, num_segments=4)
    state, addr = coll.prepare(state, fb)
    w = coll.weights(state)
    rows = coll.gather(w, addr, fb)
    plain = coll.pool(rows, fb, combiner)
    kern = coll.pool({}, fb, combiner, weights=w, addresses=addr, use_pallas=True, max_bag=4)
    ref = coll.dense_reference(coll.flush(state), fb)
    for f in fb.segments:
        assert torch.equal(kern[f], plain[f]), f
        want = segment_sum(ref[f], fb.segments[f], 4)
        if combiner == "mean":
            cnt = segment_sum((fb.ids[f] >= 0).float(), fb.segments[f], 4)
            want = want / torch.clamp_min(cnt, 1.0)[:, None]
        assert torch.equal(plain[f], want), f


def test_host_wire_bytes_exact_past_float32_resolution():
    tables = [col.TableConfig("t", vocab=64, dim=8, ids_per_step=8, cache_ratio=0.5,
                              placement=col.Placement.CACHED)]
    coll = col.EmbeddingCollection(tables, col.PlacementPlanner(10**9).plan(tables))
    state = coll.init(0, device="cpu")
    moved = 2**24 + 1  # row bytes 32: the exact total 2^29 + 32 is no float32
    slab = state.slabs["t"]
    state = col.CollectionState(slabs={"t": dataclasses.replace(
        slab, cache=dataclasses.replace(slab.cache, misses=torch.tensor(moved,
                                                                        dtype=torch.int32)))})
    m = coll.metrics(state)
    exact = sum(int(m["host_moved_rows"][k]) * int(m["host_row_bytes"][k])
                for k in m["host_moved_rows"])
    assert exact == moved * 32
    assert int(m["host_wire_bytes"]) != moved * 32


def test_all_device_plan_has_no_cache_bookkeeping():
    tables = [col.TableConfig("a", vocab=32, dim=4, ids_per_step=8),
              col.TableConfig("b", vocab=16, dim=4, ids_per_step=8)]
    coll = col.EmbeddingCollection.create(tables, budget_bytes=10**6)
    assert set(coll.device_slabs) == {"a", "b"} and not coll.cached_slabs
    state = coll.init(0, device="cpu")
    fb = tfb({"a": np.array([1, -1, 31], np.int32), "b": np.array([15, 0, -1], np.int32)})
    state, addr, rows = coll.lookup(state, fb)
    assert torch.equal(addr["a"], fb.ids["a"])
    m = coll.metrics(state)
    assert float(m["hit_rate"]) == 0.0 and int(m["cache_misses"]) == 0
    assert coll.device_bytes()["device_total"] == (32 + 16) * 4 * 4


def test_collect_counts_stream_routes_features():
    tables = [col.TableConfig("items", vocab=10, dim=4, ids_per_step=8,
                              feature_names=("hist", "target")),
              col.TableConfig("users", vocab=5, dim=4, ids_per_step=4)]
    coll = col.EmbeddingCollection.create(tables)
    stream = [col.FeatureBatch(ids={"hist": torch.tensor([1, 1, -1]),
                                    "target": torch.tensor([1]),
                                    "users": torch.tensor([4])}) for _ in range(3)]
    counts = coll.collect_counts_stream(iter(stream))
    assert counts["items"][1] == 9 and counts["users"][4] == 3
    assert counts["items"].sum() == 9
