"""The port's adaptive frequency refresh (``core/refresh.py``, the
collections' ``refresh``, the trainers' ``refresh_interval``, the serve
engine's ``refresh_every``, ``--refresh-interval`` on both launchers)
against ``repro.core.refresh`` and the reference's wiring, ported from
``tests/test_refresh.py``.

Tolerances: swap plans, reports and every state leaf after a refresh
(index maps, tracker slices, counters, arena, host payload and sideband)
bitwise; the reference's surgery runs eagerly (``jax.disable_jit``) where
a codec encodes or decodes, as its int8 encode moves by an ulp under
``jit``.  The tracker's decay is bitwise
the reference's too (``freq.decay_factor`` follows XLA's CPU lowering), so
the drift runs' per-step hit and miss counts are equal.  Losses and scores
within rtol 1e-5 of the JAX trainers and engine (torch and XLA reduce the
matmuls in different orders), and bitwise against the port's own run
without a refresh.  The port's refresh permutes the host table in place,
so each refresh runs on its own converted state.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_tree_equal, jax_to_numpy

from repro.core import collection as jcol
from repro.core import freq as jfreq
from repro.core import refresh as jref
from repro.core import sharded as jsh
from repro.data import synth as jsynth
from repro.models.dlrm import DLRM as JDLRM
from repro.models.dlrm import DLRMConfig as JDLRMConfig
from repro_torch import convert
from repro_torch.core import collection as col
from repro_torch.core import freq
from repro_torch.core import refresh
from repro_torch.core import sharded as tsh
from repro_torch.data import synth
from repro_torch.models.dlrm import DLRM, DLRMConfig
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.trainer import PipelinedTrainer, Trainer, TrainerConfig

RTOL = 1e-5


def _tables(mod):
    return [mod.TableConfig("big", vocab=512, dim=8, ids_per_step=16, cache_ratio=0.1),
            mod.TableConfig("small", vocab=96, dim=8, ids_per_step=16, cache_ratio=0.3)]


def _counts():
    rng = np.random.default_rng(1)
    return {t.name: rng.integers(0, 50, t.vocab) for t in _tables(jcol)}


def _jfb(n, seed):
    rng = np.random.default_rng(seed)
    return jcol.FeatureBatch(ids={t.name: jnp.asarray(rng.integers(-1, t.vocab, n).astype(np.int32))
                                  for t in _tables(jcol)})


def _tfb(n, seed):
    rng = np.random.default_rng(seed)
    return col.FeatureBatch(ids={t.name: torch.from_numpy(rng.integers(-1, t.vocab, n).astype(
        np.int32)) for t in _tables(col)})


def _dirty(jc, js):
    """Twelve lookups, then a prepare and an SGD step: dirty resident rows."""
    lookup = jax.jit(lambda s, f: jc.lookup(s, f))
    for i in range(12):
        js, _, _ = lookup(js, _jfb(16, 100 + i))
    js, _ = jax.jit(lambda s, f: jc.prepare(s, f))(js, _jfb(16, 777))
    return jc.apply_grads(js, {k: jnp.ones_like(v) for k, v in jc.weights(js).items()}, 0.1)


def _report(rep):
    return dataclasses.asdict(rep)


def _both_refresh(jc, js, tc, cfg_kw, writeback=True):
    """Refresh the JAX state and its conversion; check reports and every
    state leaf bitwise.  Returns (JAX report, port state).  The reference
    runs eagerly where a write-back encodes or decodes (other moves are
    bitwise under ``jit``)."""
    ts = convert.collection_state_from_numpy(jax_to_numpy(js), device="cpu", collection=tc)
    coded = writeback and any(c != "fp32" for c in (*tc.host_precision.values(),
                                                    *tc.arena_precision.values()))
    with jax.disable_jit(coded):
        js2, jrep = jc.refresh(js, jref.RefreshConfig(**cfg_kw), writeback=writeback)
    ts2, trep = tc.refresh(ts, refresh.RefreshConfig(**cfg_kw), writeback=writeback)
    assert _report(trep) == _report(jrep)
    assert_tree_equal(jax_to_numpy(js2), convert.to_numpy(ts2), "refreshed")
    return jrep, ts2


# --------------------------------------------------------------------------
# the tracker's decay and the swap plan
# --------------------------------------------------------------------------


@pytest.mark.parametrize("half_life", [1024, 18, 5, 7])
def test_tracker_touch_bitwise_reference(half_life):
    """``tracker_touch`` (decay from ``last_touch``, fused bump) gives the
    jitted reference's float32 scores bit for bit."""
    rng = np.random.default_rng(half_life)
    vocab = 4096
    score = rng.gamma(1.5, 20.0, vocab).astype(np.float32)
    last = rng.integers(0, 3000, vocab).astype(np.int32)
    rows = rng.permutation(vocab)[:1500].astype(np.int32)
    valid = rng.random(1500) < 0.9
    jt = jfreq.FreqTracker(*(jnp.asarray(x) for x in (score, last)), *(jnp.zeros(()),) * 2,
                           *(jnp.zeros((), jnp.int32),) * 2)
    want = jax.jit(lambda t, r, v, s: jfreq.tracker_touch(t, r, v, s, half_life))(
        jt, jnp.asarray(rows), jnp.asarray(valid), jnp.int32(3100))
    tt = freq.FreqTracker(torch.from_numpy(score), torch.from_numpy(last), *(torch.zeros(()),) * 2,
                          *(torch.zeros((), dtype=torch.int32),) * 2)
    got = freq.tracker_touch(tt, torch.from_numpy(rows), torch.from_numpy(valid),
                             torch.tensor(3100, dtype=torch.int32), half_life)
    assert np.array_equal(got.score.numpy(), np.asarray(want.score))
    assert np.array_equal(got.last_touch.numpy(), np.asarray(want.last_touch))
    dt = np.arange(0, 200_000, dtype=np.int32)
    want_d = jax.jit(lambda d: jnp.exp2(-d.astype(jnp.float32) / half_life))(jnp.asarray(dt))
    assert np.array_equal(freq.decay_factor(torch.from_numpy(dt), half_life).numpy(),
                          np.asarray(want_d))


def _scores(kind, n, rng):
    if kind == "random":
        return rng.gamma(0.7, 3.0, n)
    if kind == "ties":
        return rng.integers(0, 4, n).astype(np.float64) * 0.5
    return np.zeros((n,))


@pytest.mark.parametrize("kind", ["random", "ties", "zeros"])
@pytest.mark.parametrize("min_gain", [0.0, 0.25])
def test_plan_swaps_bitwise_reference(kind, min_gain):
    """The partition-based selection gives the reference's full-lexsort
    plan: every cut of ``max_swaps``, hot sets contiguous and scattered."""
    rng = np.random.default_rng(3)
    for n, n_hot in ((64, 16), (5000, 700), (20_000, 19_000)):
        s = _scores(kind, n, rng)
        for hot in (np.arange(n) < n_hot, rng.random(n) < n_hot / n):
            for k in (0, 1, 7, 512, n):
                want = jref.plan_swaps(s, hot, k, min_gain)
                got = refresh.plan_swaps(s, hot, k, min_gain)
                assert all(np.array_equal(w, g) and g.dtype == np.int64
                           for w, g in zip(want, got)), (n, k)


def test_plan_swaps_bounded_deterministic_and_boundary_only():
    scores = np.asarray([5.0, 1.0, 0.5, 9.0, 0.2, 7.0], np.float64)
    hot = np.asarray([True, True, True, False, False, False])
    a, b = refresh.plan_swaps(scores, hot, max_swaps=8)
    assert a.tolist() == [2, 1] and b.tolist() == [3, 5]
    assert refresh.plan_swaps(scores, hot, max_swaps=1)[0].tolist() == [2]
    assert refresh.plan_swaps(np.ones((6,)), hot, max_swaps=8)[0].size == 0
    assert refresh.plan_swaps(scores, hot, max_swaps=8, min_gain=5.0)[0].tolist() == [2, 1]
    assert refresh.plan_swaps(scores, hot, max_swaps=8, min_gain=7.0)[0].tolist() == [2]


# --------------------------------------------------------------------------
# unsharded refresh: the state bitwise the reference's
# --------------------------------------------------------------------------


@pytest.mark.parametrize("host,arena", [("fp32", "fp32"), ("fp16", "fp32"), ("int8", "fp32"),
                                        ("int8", "int8"), ("fp32", "int8")])
def test_refresh_cached_slab_state_bitwise(host, arena):
    """A dirty state through both refreshes: idx_map, slot maps, tracker
    slices, counters, arena, host payload and sideband bitwise."""
    kw = dict(cache_ratio=0.1, host_precision=host, arena_precision=arena)
    jc = jcol.EmbeddingCollection.create(_tables(jcol), **kw)
    tc = col.EmbeddingCollection.create(_tables(col), **kw)
    js = _dirty(jc, jc.init(jax.random.PRNGKey(0), counts=_counts()))
    jrep, _ = _both_refresh(jc, js, tc, dict(max_swaps=32))
    assert jrep.total_swaps == 32


def test_budget_mode_refresh_covers_cached_and_grouped_slabs():
    """The planner's CACHED table and GROUPED arena both re-rank (a DEVICE
    table has none), bitwise the reference, read-only (``writeback=False``)
    as serving calls it."""
    tables = [*_tables(col), col.TableConfig("dev", vocab=32, dim=8, ids_per_step=16),
              col.TableConfig("tiny", vocab=40, dim=8, ids_per_step=16)]
    jtables = [*_tables(jcol), jcol.TableConfig("dev", vocab=32, dim=8, ids_per_step=16),
               jcol.TableConfig("tiny", vocab=40, dim=8, ids_per_step=16)]
    kw = dict(group_below_rows=50, host_precision="int8")
    jc = jcol.EmbeddingCollection(jtables, jcol.PlacementPlanner(16_000, **kw).plan(jtables))
    tc = col.EmbeddingCollection(tables, col.PlacementPlanner(16_000, **kw).plan(tables))
    assert tc.device_slabs and set(tc.cached_slabs) == {"big", col.SHARED_ARENA}
    js = jc.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    prep = jax.jit(lambda s, f: jc.prepare(s, f, writeback=False))
    for i in range(10):
        ids = {t.name: jnp.asarray(rng.integers(0, t.vocab, 16).astype(np.int32)) for t in jtables}
        js, _ = prep(js, jcol.FeatureBatch(ids=ids))
    jrep, _ = _both_refresh(jc, js, tc, dict(max_swaps=8), writeback=False)
    assert set(jrep.swaps) == {"big", col.SHARED_ARENA} and jrep.total_swaps > 0


def test_refresh_is_pure_reindexing():
    """fp32: dense_reference, full_lookup and cached lookups bitwise before
    and after a refresh of a dirty state; int8: a clean state's reads
    bitwise too.  The counters reach ``metrics()``."""
    tc = col.EmbeddingCollection.create(_tables(col), cache_ratio=0.1)
    jc = jcol.EmbeddingCollection.create(_tables(jcol), cache_ratio=0.1)
    js = _dirty(jc, jc.init(jax.random.PRNGKey(0), counts=_counts()))
    probe = _tfb(16, 999)
    ids = torch.arange(64, dtype=torch.int32)
    s0 = convert.collection_state_from_numpy(jax_to_numpy(js), device="cpu", collection=tc)
    before = tc.dense_reference(tc.flush(s0), probe)
    fl_before = tc.full_lookup(s0, "big", ids)
    rows_before = tc.lookup(s0, probe)[2]
    s1 = convert.collection_state_from_numpy(jax_to_numpy(js), device="cpu", collection=tc)
    s1, rep = tc.refresh(s1, refresh.RefreshConfig(max_swaps=32))
    assert rep.total_swaps > 0
    after = tc.dense_reference(tc.flush(s1), probe)
    assert torch.equal(tc.full_lookup(s1, "big", ids), fl_before)
    m = tc.metrics(s1)
    assert int(m["refresh_swaps"]) == rep.total_swaps
    assert int(m["refresh_rows_moved"]) == rep.total_rows_moved
    rows_after = tc.lookup(s1, probe)[2]
    for f in before:
        assert torch.equal(before[f], after[f]) and torch.equal(rows_before[f], rows_after[f])
    slab = s1.slabs[col.SHARED_ARENA]
    assert sorted(slab.idx_map.tolist()) == list(range(slab.idx_map.numel()))
    s2r, r2s = slab.cache.slot_to_row, slab.cache.row_to_slot
    held = s2r >= 0
    assert torch.equal(r2s[s2r[held].long()], torch.nonzero(held)[:, 0].to(torch.int32))

    t8 = col.EmbeddingCollection.create(_tables(col), cache_ratio=0.1, host_precision="int8")
    st = t8.flush(t8.init(0, counts=_counts(), device="cpu"))
    for i in range(12):
        st = t8.lookup(st, _tfb(16, 100 + i))[0]
    st = t8.flush(st)
    before = t8.dense_reference(st, probe)
    st, rep = t8.refresh(st, refresh.RefreshConfig(max_swaps=32))
    assert rep.total_swaps > 0
    after = t8.dense_reference(t8.flush(st), probe)
    assert all(torch.equal(before[f], after[f]) for f in before)


def test_refresh_noop_when_ranking_already_right():
    tables = [col.TableConfig("t", vocab=64, dim=4, ids_per_step=8, cache_ratio=0.25)]
    coll = col.EmbeddingCollection.create(tables, cache_ratio=0.25)
    state = coll.init(0, device="cpu")
    for _ in range(6):
        ids = torch.tensor([0, 1, 2, 3, -1, -1, 0, 1], dtype=torch.int32)
        state, _ = coll.prepare(state, col.FeatureBatch(ids={"t": ids}))
    idx = state.slabs[col.SHARED_ARENA].idx_map.clone()
    state2, rep = coll.refresh(state)
    assert rep.total_swaps == 0 and torch.equal(state2.slabs[col.SHARED_ARENA].idx_map, idx)


# --------------------------------------------------------------------------
# sharded refresh and rebalance
# --------------------------------------------------------------------------


def _sharded(S, K, host="fp32", dirty=True):
    kw = dict(num_shards=S, replicate_top_k=K, cache_ratio=0.1, host_precision=host)
    jc = jsh.ShardedEmbeddingCollection.create(_tables(jcol), **kw)
    tc = tsh.ShardedEmbeddingCollection.create(_tables(col), **kw)
    js = jc.init(jax.random.PRNGKey(0), counts=_counts())
    return jc, (_dirty(jc, js) if dirty else js), tc


def test_one_shard_refresh_bitwise_unsharded():
    un = col.EmbeddingCollection.create(_tables(col), cache_ratio=0.1)
    jun = jcol.EmbeddingCollection.create(_tables(jcol), cache_ratio=0.1)
    jc, js, tc = _sharded(1, 0)
    _, ts = _both_refresh(jc, js, tc, dict(max_swaps=32))
    ju = _dirty(jun, jun.init(jax.random.PRNGKey(0), counts=_counts()))
    us = convert.collection_state_from_numpy(jax_to_numpy(ju), device="cpu", collection=un)
    us, rep = un.refresh(us, refresh.RefreshConfig(max_swaps=32))
    a, b = us.slabs[col.SHARED_ARENA], ts.slabs[col.SHARED_ARENA]
    assert rep.total_swaps == 32
    assert torch.equal(a.idx_map, b.idx_map)
    assert torch.equal(a.full["weight"], tsh.flat_store(b.full)["weight"])
    assert torch.equal(a.cache.row_to_slot, b.cache.row_to_slot[0])
    assert torch.equal(a.cache.slot_to_row, b.cache.slot_to_row[0])
    assert torch.equal(a.cache.cached_rows["weight"], b.cache.cached_rows["weight"][0])
    assert torch.equal(a.cache.tracker.score, b.cache.tracker.score[0])


@pytest.mark.parametrize("S,K,host,budget", [(3, 8, "fp32", None), (3, 0, "fp32", 4),
                                             (4, 0, "fp32", None), (4, 8, "fp32", 4),
                                             (4, 8, "fp32", 0), (4, 8, "int8", None),
                                             (4, 8, "fp16", 4)])
def test_sharded_refresh_state_bitwise(S, K, host, budget):
    """The content exchange between fixed homes (a replicated head pushed
    and pulled), per-shard counter shares and the exchange budget, bitwise
    the reference; a budget keeps ``cross_shard_rows`` within it and defers
    the rest of the unbudgeted plan."""
    jc, js, tc = _sharded(S, K, host)
    jrep, ts = _both_refresh(jc, js, tc, dict(max_swaps=32, exchange_budget=budget))
    if budget is not None:
        _, unb = jc.refresh(js, jref.RefreshConfig(max_swaps=32))
        for s in jrep.swaps:
            assert jrep.cross_shard_rows[s] <= budget
            assert jrep.swaps[s] + jrep.deferred_swaps[s] == unb.swaps[s]
    if host == "fp32":  # after the swaps, lookups still read the flushed host table
        probe = _tfb(16, 999)
        ts, _, rows = tc.lookup(ts, probe)
        ref = tc.dense_reference(tc.flush(ts), probe)
        assert all(torch.equal(rows[f], ref[f]) for f in rows)


@pytest.mark.parametrize("host,K,max_swaps", [("fp32", 0, 0), ("int8", 8, 16)])
def test_rebalance_rehomes_bitwise_reference(host, K, max_swaps):
    """Above the threshold every rank gets its ``assign_devices`` home on
    the live scores; host rows and trackers move by slab, the caches are
    re-warmed, all bitwise the reference's gather; lookups read the same
    rows; a second pass below the threshold moves nothing."""
    kw = dict(num_shards=2, replicate_top_k=K, cache_ratio=0.25, host_precision=host)
    jt = [jcol.TableConfig("t", vocab=128, dim=8, ids_per_step=16, cache_ratio=0.25)]
    tt = [col.TableConfig("t", vocab=128, dim=8, ids_per_step=16, cache_ratio=0.25)]
    jc = jsh.ShardedEmbeddingCollection.create(jt, **kw)
    tc = tsh.ShardedEmbeddingCollection.create(tt, **kw)
    js = jc.init(jax.random.PRNGKey(0))
    tc.init(0, device="cpu")
    prep = jax.jit(lambda s, f: jc.prepare(s, f))
    for i in range(8):
        ids = jnp.asarray(((np.arange(16) * 2 + 2 * i) % 128).astype(np.int32))
        js, _ = prep(js, jcol.FeatureBatch(ids={"t": ids}))
    cfg = dict(max_swaps=max_swaps, rebalance_threshold=1.2)
    probe = col.FeatureBatch(ids={"t": torch.arange(128, dtype=torch.int32)})
    ts0 = convert.collection_state_from_numpy(jax_to_numpy(js), device="cpu", collection=tc)
    before = tc.dense_reference(tc.flush(ts0), probe)["t"]
    imb0 = float(tc.metrics(ts0)["shard_imbalance"])
    jrep, ts = _both_refresh(jc, js, tc, cfg)
    sname = col.SHARED_ARENA
    assert jrep.rebalance_moves[sname] > 0 and jrep.rebalance_imbalance[sname] > 1.2
    assert np.array_equal(tc.assignments[sname].owner, ts.slabs[sname].rank_owner.numpy())
    assert float(tc.metrics(ts)["shard_imbalance"]) < imb0
    after = tc.dense_reference(tc.flush(ts), probe)["t"]
    if host == "fp32":
        assert torch.equal(before, after)
    ts, rep2 = tc.refresh(ts, refresh.RefreshConfig(max_swaps=0, rebalance_threshold=1.2))
    assert rep2.rebalance_moves[sname] == 0


# --------------------------------------------------------------------------
# drift recovery: bench_drift's SMOKE shape against the reference
# --------------------------------------------------------------------------


def _drift_run(mod, with_refresh, init, fb_of, refresh_cfg):
    vocab, batch, drift_every = 20_000, 512, 40
    spec = synth.DriftingZipfSpec(base=synth.ZipfSparseSpec(vocab_sizes=(vocab,)),
                                  drift_every=drift_every)
    cnt = np.zeros((vocab,), np.int64)
    for s in range(drift_every):
        np.add.at(cnt, synth.drifting_sparse_batch(spec, batch, 0, s)["sparse"].reshape(-1), 1)
    table = mod.TableConfig("items", vocab, 8, ids_per_step=batch, cache_ratio=0.04,
                            freq_half_life=drift_every // 8)
    coll = mod.EmbeddingCollection.create([table], cache_ratio=0.04)
    state = init(coll, {"items": cnt})
    prep = jax.jit(lambda st, fb: coll.prepare(st, fb)) if mod is jcol else coll.prepare
    hits, misses = [], []
    for s in range(3 * drift_every):
        state, _ = prep(state, fb_of(synth.drifting_sparse_batch(spec, batch, 0, s)["sparse"]))
        c = state.slabs[col.SHARED_ARENA].cache
        hits.append(int(c.hits))
        misses.append(int(c.misses))
        if with_refresh and (s + 1) % 2 == 0:
            state, _ = coll.refresh(state, refresh_cfg(max_swaps=512, min_gain=0.25))
    m = coll.metrics(state)
    return hits, misses, int(m["refresh_swaps"]), int(m["refresh_rows_moved"])


def test_drift_smoke_counts_equal_reference():
    """``benchmarks/bench_drift.py``'s SMOKE shape (vocab 20 000, batch
    512, 120 steps, a refresh every 2 steps): per-step hits and misses,
    swaps and rows moved equal to the JAX run, with and without refresh;
    the refresh recovers hit rate after the drift."""
    def jrun(with_refresh):
        return _drift_run(jcol, with_refresh,
                          lambda c, cnt: c.init(jax.random.PRNGKey(0), counts=cnt),
                          lambda ids: jcol.FeatureBatch.from_onehot(("items",), jnp.asarray(ids)),
                          jref.RefreshConfig)

    def trun(with_refresh):
        return _drift_run(col, with_refresh,
                          lambda c, cnt: c.init(0, counts=cnt, device="cpu"),
                          lambda ids: col.FeatureBatch.from_onehot(("items",),
                                                                   torch.from_numpy(ids)),
                          refresh.RefreshConfig)

    runs = {}
    for with_refresh in (False, True):
        runs[with_refresh] = got = trun(with_refresh)
        assert got == jrun(with_refresh), with_refresh
    assert runs[True][2] > 0 and runs[True][3] == 2 * runs[True][2]

    def post(r):
        h, m = np.diff([0] + r[0]), np.diff([0] + r[1])
        return h[-20:].sum() / (h[-20:].sum() + m[-20:].sum())

    assert post(runs[True]) > post(runs[False])


# --------------------------------------------------------------------------
# trainer / serve / launcher wiring
# --------------------------------------------------------------------------

_CFG = dict(vocab_sizes=(4096, 256, 64), embed_dim=8, batch_size=16, cache_ratio=0.25, lr=0.1,
            bottom_mlp=(16, 8), top_mlp=(16,))
_SPEC = synth.ZipfSparseSpec(vocab_sizes=_CFG["vocab_sizes"], n_dense=13)
_JINIT = {}


def _init():
    if not _JINIT:
        _JINIT["tree"] = jax_to_numpy(JDLRM(JDLRMConfig(**_CFG)).init(jax.random.PRNGKey(0)))
    return convert.state_from_numpy(_JINIT["tree"], device="cpu")


def _batch(step):
    return synth.sparse_batch(_SPEC, 16, 0, step)


def _port_run(refresh_interval, depth=0, steps=8):
    model = DLRM(DLRMConfig(**_CFG))
    tc = TrainerConfig(max_steps=steps, refresh_interval=refresh_interval, pipeline_depth=depth)
    kw = dict(init_fn=_init, make_batch=_batch, flush_fn=model.flush, device="cpu",
              refresh_fn=model.refresh)
    if depth:
        tr = PipelinedTrainer(tc, plan_fn=model.plan_step, compute_fn=model.compute_step,
                              apply_fn=model.apply_step, **kw)
    else:
        tr = Trainer(tc, step_fn=model.train_step, **kw)
    tr.run()
    return tr.history


def test_refresh_interval_losses_bitwise_no_refresh_and_close_to_reference():
    """The serial fp32 losses with ``refresh_interval`` 3 equal the run
    without it bit for bit; against the reference trainer with the same
    interval: losses within rtol 1e-5, the same refresh counters."""
    from repro.train.trainer import Trainer as JTrainer
    from repro.train.trainer import TrainerConfig as JTrainerConfig

    base = _port_run(None)
    hist = _port_run(3)
    assert [h["loss"] for h in hist] == [h["loss"] for h in base]
    assert any(h["refresh_swaps"] > 0 for h in hist)
    jmodel = JDLRM(JDLRMConfig(**_CFG))
    jt = JTrainer(JTrainerConfig(max_steps=8, refresh_interval=3),
                  init_fn=lambda: jmodel.init(jax.random.PRNGKey(0)),
                  step_fn=jax.jit(jmodel.train_step),
                  make_batch=lambda s: {k: jnp.asarray(v) for k, v in
                                        jsynth.sparse_batch(_SPEC, 16, 0, s).items()},
                  flush_fn=jmodel.flush, refresh_fn=jmodel.refresh)
    jt.run()
    np.testing.assert_allclose([h["loss"] for h in hist], [h["loss"] for h in jt.history],
                               rtol=RTOL, atol=0)
    for key in ("refresh_swaps", "refresh_rows_moved", "cache_hits", "cache_misses"):
        assert [h[key] for h in hist] == [h[key] for h in jt.history], key


@pytest.mark.parametrize("depth", [1, 3])
def test_pipelined_trainer_with_refresh_bitwise_serial(depth):
    """Group-boundary refreshes keep merged plans valid: the pipelined run
    with ``refresh_interval`` 2 gives the serial no-refresh losses bit for
    bit, over the same steps, and the refresh ran."""
    serial = _port_run(None, steps=7)
    piped = _port_run(2, depth=depth, steps=7)
    assert [h["loss"] for h in piped] == [h["loss"] for h in serial]
    assert [h["step"] for h in piped] == list(range(7))
    assert any(h["refresh_swaps"] > 0 for h in piped)


def test_pipelined_refresh_plans_after_the_refresh():
    """When a refresh falls due inside a group, the next group's plan is
    made after it (from the refreshed index state), not at the group's
    first compute; the cadence counts absolute steps."""
    model = DLRM(DLRMConfig(**_CFG))
    events = []

    def plan_fn(state, batch, window=()):
        events.append("plan")
        return model.plan_step(state, batch, window)

    def refresh_fn(state):
        events.append("refresh")
        return model.refresh(state)

    tr = PipelinedTrainer(TrainerConfig(max_steps=6, pipeline_depth=2, refresh_interval=3),
                          init_fn=_init, plan_fn=plan_fn, compute_fn=model.compute_step,
                          apply_fn=model.apply_step, make_batch=_batch, device="cpu",
                          refresh_fn=refresh_fn)
    tr.run()
    # groups [0,1] [2,3] [4,5]: due at step 3, so after group [2,3]; the
    # plan of [4,5] follows it
    assert events == ["plan", "plan", "refresh", "plan"]


def test_serve_engine_refresh_scores_unchanged():
    """``refresh_every`` 2: scores bitwise the engine without it, batch by
    batch, and within rtol 1e-5 of the reference engine with the same
    hook; the same refresh counters."""
    from repro.serve.engine import ServeEngine as JServeEngine

    pad = {"dense": np.zeros((13,), np.float32), "sparse": np.zeros((3,), np.int32),
           "label": np.zeros((), np.float32)}

    def engine(every):
        model = DLRM(DLRMConfig(**_CFG))
        return ServeEngine(model.serve_step, _init(), batch_size=16, pad_example=pad,
                           device="cpu",
                           state_stats_fn=lambda s: model.collection.metrics(s["emb"],
                                                                             writeback=False),
                           refresh_fn=(lambda s: model.refresh(s, writeback=False))
                           if every else None, refresh_every=every)

    jmodel = JDLRM(JDLRMConfig(**_CFG))
    jeng = JServeEngine(jmodel.serve_step, jmodel.init(jax.random.PRNGKey(0)), batch_size=16,
                        pad_example=pad,
                        state_stats_fn=lambda s: jmodel.collection.metrics(s["emb"],
                                                                           writeback=False),
                        refresh_fn=lambda s: jmodel.refresh(s, writeback=False), refresh_every=2)
    plain, refreshing = engine(None), engine(2)
    for s in range(6):
        b = _batch(s)
        got = refreshing.score(b)
        assert np.array_equal(got, plain.score(b)), s
        np.testing.assert_allclose(got, jeng.score(b), rtol=RTOL, atol=1e-6)
    summ, jsumm = refreshing.summary(), jeng.summary()
    assert summ["refresh_swaps"] > 0
    for key in ("refresh_swaps", "refresh_rows_moved", "cache_hits", "cache_misses"):
        assert summ[key] == jsumm[key], key


@pytest.mark.parametrize("extra", [[], ["--pipeline-depth", "2", "--model-shards", "2"]])
def test_train_launcher_refresh_interval_matches_reference(capsys, monkeypatch, extra):
    """``launch/train.py --refresh-interval 2`` (serial, and pipelined over
    2 shards) from the reference launcher's initial state: the same hits,
    misses, host wire bytes and refresh counters per step, losses within
    rtol 1e-5, the same refresh line."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train

    runs = []
    base = jtrain.PipelinedTrainer if extra else jtrain.Trainer

    class Recorded(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            runs.append(self)

    monkeypatch.setattr(jtrain, base.__name__, Recorded)
    argv = ["--arch", "dlrm-criteo", "--steps", "5", "--batch", "16", "--refresh-interval", "2",
            *extra]
    monkeypatch.setattr("sys.argv", ["train", *argv, "--use-pallas-plan"])
    jtrain.main()
    want_out = capsys.readouterr().out
    jcfg = JDLRMConfig(vocab_sizes=(100_000, 50_000, 20_000), embed_dim=32, batch_size=16,
                       cache_ratio=0.02, lr=0.3, bottom_mlp=(64, 32), top_mlp=(64,),
                       use_pallas_plan=True, model_shards=2 if extra else 0)
    init = jax_to_numpy(JDLRM(jcfg).init(jax.random.PRNGKey(0)))
    monkeypatch.setattr(DLRM, "init", lambda self, seed, counts=None, device=None:
                        convert.state_from_numpy(init, device=device))
    got = train.main(["--device", "cpu", *argv])
    got_out = capsys.readouterr().out
    want = runs[0].history
    assert len(got.history) == len(want) == 5
    for g, w in zip(got.history, want):
        for key in ("cache_hits", "cache_misses", "host_wire_bytes", "refresh_swaps",
                    "refresh_rows_moved"):
            assert g[key] == w[key], key
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=RTOL, atol=0)
    assert got.history[-1]["refresh_swaps"] > 0
    pattern = r"adaptive refresh: (\d+) rank swaps, (\d+)"
    assert re.search(pattern, got_out).groups() == re.search(pattern, want_out).groups()


def test_serve_launcher_refresh_interval_matches_reference(capsys, monkeypatch):
    """``launch/serve.py --refresh-interval 2`` against the reference
    launcher: the same hits, misses, wire bytes and refresh counters."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve

    argv = ["--arch", "dlrm-criteo", "--requests", "64", "--batch", "16",
            "--refresh-interval", "2"]
    got = serve.main(["--device", "cpu", *argv])
    capsys.readouterr()
    monkeypatch.setattr("sys.argv", ["serve", *argv])
    jserve.main()
    out = capsys.readouterr().out.strip().splitlines()
    assert got["refresh_swaps"] > 0
    for key in ("requests", "cache_hits", "cache_misses", "host_wire_bytes", "refresh_swaps",
                "refresh_rows_moved"):
        want = float(re.search(rf"'{key}': ([0-9.]+)", out[-2]).group(1))
        assert float(got[key]) == want, key
