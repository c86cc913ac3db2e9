"""The port's lookahead pipelining (``cache.plan_prepare(future_rows=)``,
``EmbeddingCollection.plan_prepare(fb_future=)`` / ``prepare_lookahead``,
``Prefetcher.lookahead``, ``PipelinedTrainer``) against the JAX package,
and the reference's own ``tests/test_pipeline.py`` ported to it (its two
bag-pooling tests live in ``test_torch_embedding_bag.py``).

Tolerances: lookahead plans (index state, victim order, ``miss_rows``,
future addresses, ``future_unresident``) bitwise, the tracker's float
leaves within ``torch_parity.TRACKER_RTOL``; the pipelined DLRM's losses
within the port's fp32 rtol 1e-5 of the JAX ``PipelinedTrainer``'s (torch
and XLA reduce the matmuls in different orders); within the port,
pipelined fp32 losses equal the serial ones bitwise, and with an int8 host
tier within the reference's 5e-3.
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_tree_equal, jax_to_numpy

from repro.core import cache as jcache
from repro.core import collection as jcol
from repro.core.policies import Policy as JPolicy
from repro.models.dlrm import DLRM as JDLRM
from repro.models.dlrm import DLRMConfig as JDLRMConfig
from repro.store.host_store import HostStore as JHostStore
from repro.train.trainer import PipelinedTrainer as JPipelinedTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch import convert
from repro_torch.convert import to_numpy
from repro_torch.core import cache
from repro_torch.core import collection as col
from repro_torch.core.policies import Policy
from repro_torch.data import synth
from repro_torch.data.pipeline import Prefetcher
from repro_torch.models.dlrm import DLRM, DLRMConfig
from repro_torch.store.host_store import HostStore
from repro_torch.train.trainer import PipelinedTrainer, Trainer, TrainerConfig

CPU = torch.device("cpu")


def _arena(state):
    return state.slabs[col.SHARED_ARENA]


def _resident(state, raw_id):
    slab = _arena(state)
    return int(slab.cache.row_to_slot[int(slab.idx_map[raw_id])]) >= 0


def _fb(ids):
    return col.FeatureBatch(ids={"t": torch.tensor(ids, dtype=torch.int32)})


def _coll(vocab=100, cache_ratio=0.12, ids=4, **kw):
    tables = [col.TableConfig("t", vocab=vocab, dim=4, ids_per_step=ids, **kw)]
    return col.EmbeddingCollection.create(tables, cache_ratio=cache_ratio)


def _exact(coll, state, addr, fb):
    rows = coll.gather(coll.weights(state), addr, fb)
    ref = coll.dense_reference(coll.flush(state), fb)
    assert torch.equal(rows["t"], ref["t"])


# --------------------------------------------------------------------------
# the lookahead plan against the JAX package, bitwise
# --------------------------------------------------------------------------


@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("policy", [Policy.FREQ_LFU, Policy.LRU])
@pytest.mark.parametrize("protect_via_inverse", [True, False])
def test_lookahead_plan_matches_reference(policy, pallas, protect_via_inverse):
    """``plan_prepare(future_rows=)`` over 5 steps from a warm cache: every
    plan field (victim order, ``miss_rows``, the index image, counters) and
    the applied state bitwise; the window makes ``kv`` reach the capacity
    (40 = 16 + 32 clamped), so the threshold runs at ``kv == n``."""
    geo = dict(vocab=128, capacity=40, ids_per_step=16, buffer_rows=64, use_pallas_plan=pallas,
               protect_via_inverse=protect_via_inverse)
    jcfg = jcache.CacheConfig(policy=JPolicy(policy.value), **geo)
    tcfg = cache.CacheConfig(policy=policy, **geo)
    rng = np.random.default_rng(0)
    table = rng.normal(size=(128, 8)).astype(np.float32)
    jfull = JHostStore.create({"weight": jnp.asarray(table)})
    tfull = HostStore.create({"weight": torch.from_numpy(table.copy())})
    jst = jcache.init_cache(jcfg, {"weight": jnp.zeros((8,), jnp.float32)})
    tst = cache.init_cache(tcfg, {"weight": torch.zeros((8,))}, CPU)
    jfull, jst = jcache.warmup(jcfg, jfull, jst)
    tfull, tst = cache.warmup(tcfg, tfull, tst)
    loaded = 0
    for step in range(5):
        rows = np.minimum(rng.zipf(1.3, size=16) - 1, 127).astype(np.int32)
        rows[rng.random(16) < 0.15] = -1
        fut = rng.integers(-1, 128, size=32).astype(np.int32)
        jplan = jcache.plan_prepare(jcfg, jst, jnp.asarray(rows), future_rows=jnp.asarray(fut))
        tplan = cache.plan_prepare(tcfg, tst, torch.from_numpy(rows),
                                   future_rows=torch.from_numpy(fut))
        assert tplan.victim_slots.shape == (40,)
        assert_tree_equal(jax_to_numpy(jplan), to_numpy(tplan), f"plan{step}")
        jfull, jst = jcache.apply_plan(jcfg, jfull, jst, jplan)
        tfull, tst = cache.apply_plan(tcfg, tfull, tst, tplan)
        assert_tree_equal(jax_to_numpy(jst), to_numpy(tst), f"state{step}")
        loaded += int(tplan.load_active.sum())
    assert_tree_equal(jax_to_numpy(jfull), to_numpy(tfull), "full")
    assert loaded > int(tst.misses)  # the window prefetched past the demand misses


def _jfb(ids):
    return jcol.FeatureBatch(ids={k: jnp.asarray(np.asarray(v, np.int32)) for k, v in ids.items()})


def _tfb(ids):
    return col.FeatureBatch(ids={k: torch.from_numpy(np.asarray(v, np.int32))
                                 for k, v in ids.items()})


def _plans_equal(jp, tp, path):
    """A collection plan, its ``future_addresses`` tuple included."""
    want, got = jax_to_numpy(jp), to_numpy(tp)
    wf, gf = want.pop("future_addresses"), got.pop("future_addresses")
    assert len(wf) == len(gf), path
    for j, (a, b) in enumerate(zip(wf, gf)):
        assert_tree_equal(jax_to_numpy(a), b, f"{path}/future{j}")
    assert_tree_equal(want, got, path)


@pytest.mark.parametrize("pallas", [False, True])
def test_collection_lookahead_matches_reference(pallas):
    """A budget plan (one DEVICE table, two CACHED slabs, one of them only
    in the window at step 0) from the converted reference state:
    addresses, future addresses, ``future_unresident`` and the slab plans
    bitwise, step by step, under ``prepare_lookahead``'s plan + apply."""
    def tables(mod):
        return [mod.TableConfig("a", vocab=256, dim=4, ids_per_step=8, cache_ratio=0.2,
                                use_pallas_plan=pallas),
                mod.TableConfig("b", vocab=64, dim=4, ids_per_step=8, cache_ratio=0.3,
                                use_pallas_plan=pallas, placement=mod.Placement.CACHED),
                mod.TableConfig("d", vocab=16, dim=4, ids_per_step=8,
                                placement=mod.Placement.DEVICE)]
    jc = jcol.EmbeddingCollection(tables(jcol), jcol.PlacementPlanner(10**6).plan(tables(jcol)))
    tc = col.EmbeddingCollection(tables(col), col.PlacementPlanner(10**6).plan(tables(col)))
    js = jc.init(jax.random.PRNGKey(0))
    ts = convert.collection_state_from_numpy(jax_to_numpy(js), "cpu")
    rng = np.random.default_rng(5)

    def ids(names):
        return {n: rng.integers(-1, {"a": 256, "b": 64, "d": 16}[n], 8) for n in names}

    for step in range(4):
        now = ids(("a", "d") if step == 0 else ("a", "b", "d"))
        window = [ids(("a", "b", "d")), ids(("a", "b"))]
        jp = jc.plan_prepare(js, _jfb(now), fb_future=tuple(_jfb(w) for w in window))
        tp = tc.plan_prepare(ts, _tfb(now), fb_future=tuple(_tfb(w) for w in window))
        _plans_equal(jp, tp, f"plan{step}")
        if step == 0:  # "b" only in the window: its valid lanes are unresident
            assert int(tp.future_unresident) == sum(int((w["b"] >= 0).sum()) for w in window)
            assert "b" not in tp.future_addresses[0]
        js, ts = jc.apply_plan(js, jp), tc.apply_plan(ts, tp)
        assert_tree_equal(jax_to_numpy(js), to_numpy(ts), f"state{step}")


def test_pipelined_losses_match_reference_pipelined_trainer():
    """The port's ``PipelinedTrainer`` at depth 3 against the JAX one from
    the converted initial state: losses within rtol 1e-5, steps equal."""
    base = dict(vocab_sizes=(4096, 256, 64), embed_dim=8, batch_size=16, cache_ratio=0.25,
                lr=0.1, bottom_mlp=(16, 8), top_mlp=(16,), use_pallas_plan=True)
    spec = synth.ZipfSparseSpec(vocab_sizes=base["vocab_sizes"], n_dense=13)
    jmodel, tmodel = JDLRM(JDLRMConfig(**base)), DLRM(DLRMConfig(**base))
    init = jax_to_numpy(jmodel.init(jax.random.PRNGKey(0)))
    jt = JPipelinedTrainer(
        JTrainerConfig(max_steps=6, pipeline_depth=3),
        init_fn=lambda: jmodel.init(jax.random.PRNGKey(0)),
        plan_fn=jax.jit(jmodel.plan_step), compute_fn=jax.jit(jmodel.compute_step),
        apply_fn=jax.jit(jmodel.apply_step),
        make_batch=lambda s: {k: jnp.asarray(v) for k, v in
                              synth.sparse_batch(spec, 16, 0, s).items()})
    jt.run()
    tt = PipelinedTrainer(
        TrainerConfig(max_steps=6, pipeline_depth=3),
        init_fn=lambda: convert.state_from_numpy(init, device="cpu"),
        plan_fn=tmodel.plan_step, compute_fn=tmodel.compute_step, apply_fn=tmodel.apply_step,
        make_batch=lambda s: synth.sparse_batch(spec, 16, 0, s), device="cpu")
    tt.run()
    assert [h["step"] for h in tt.history] == [h["step"] for h in jt.history] == list(range(6))
    np.testing.assert_allclose([h["loss"] for h in tt.history], [h["loss"] for h in jt.history],
                               rtol=1e-5, atol=0)
    for key in ("cache_hits", "cache_misses", "host_wire_bytes"):
        assert [h[key] for h in tt.history] == [h[key] for h in jt.history], key


def test_pipelined_chunked_launcher_matches_reference_launcher(monkeypatch):
    """``launch/train.py --pipeline-depth 2 --chunk-rows 4`` on the CPU from
    the reference launcher's initial state: the same hits, misses and host
    wire bytes per step, losses within rtol 1e-5."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train

    runs = []

    class Recorded(jtrain.PipelinedTrainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            runs.append(self)

    monkeypatch.setattr(jtrain, "PipelinedTrainer", Recorded)
    argv = ["--arch", "dlrm-criteo", "--steps", "5", "--batch", "16", "--pipeline-depth", "2",
            "--chunk-rows", "4"]
    monkeypatch.setattr("sys.argv", ["train", *argv, "--use-pallas-plan"])
    jtrain.main()
    jcfg = JDLRMConfig(vocab_sizes=(100_000, 50_000, 20_000), embed_dim=32, batch_size=16,
                       cache_ratio=0.02, lr=0.3, bottom_mlp=(64, 32), top_mlp=(64,),
                       use_pallas_plan=True, chunk_rows=4)
    init = jax_to_numpy(JDLRM(jcfg).init(jax.random.PRNGKey(0)))
    monkeypatch.setattr(DLRM, "init", lambda self, seed, counts=None, device=None:
                        convert.state_from_numpy(init, device=device))
    from repro_torch.core import transmitter

    before = transmitter.moves["chunked"]
    got = train.main(["--device", "cpu", *argv])
    assert isinstance(got, PipelinedTrainer) and transmitter.moves["chunked"] > before
    want = runs[0].history
    assert len(got.history) == len(want) == 5
    for g, w in zip(got.history, want):
        for key in ("cache_hits", "cache_misses", "host_wire_bytes"):
            assert g[key] == w[key], key
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5, atol=0)


# --------------------------------------------------------------------------
# plan/apply split
# --------------------------------------------------------------------------


def test_prepare_equals_plan_then_apply():
    coll = _coll()
    s1 = coll.init(0, device="cpu")
    s2 = coll.init(0, device="cpu")
    for step in range(6):
        fb = _fb([step * 3, step * 3 + 1, 90 - step, -1])
        s1, a1 = coll.prepare(s1, fb)
        p = coll.plan_prepare(s2, fb)
        s2 = coll.apply_plan(s2, p)
        assert torch.equal(a1["t"], p.addresses["t"])
        assert_tree_equal(to_numpy(s1), to_numpy(s2))


def _zero_floats(obj):
    """A copy of a state with every float tensor zeroed (the rest shared)."""
    if isinstance(obj, torch.Tensor):
        return torch.zeros_like(obj) if obj.is_floating_point() else obj
    if isinstance(obj, dict):
        return {k: _zero_floats(v) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: _zero_floats(getattr(obj, f.name))
                                           for f in dataclasses.fields(obj)
                                           if not f.name.startswith("_")})
    return obj


def test_plan_reads_no_weights():
    """Planning is a function of ids and index state only: zeroing every
    weight changes nothing in the plan."""
    coll = _coll()
    state = coll.init(0, device="cpu")
    fb, fut = _fb([5, 6, 7, 8]), _fb([40, 41, 42, 43])
    p1, p2 = (to_numpy(coll.plan_prepare(s, fb, fb_future=(fut,)))
              for s in (state, _zero_floats(state)))
    for p in (p1, p2):  # the window's addresses as a dict of batches
        p["future_addresses"] = dict(enumerate(p["future_addresses"]))
    assert_tree_equal(p1, p2)


# --------------------------------------------------------------------------
# lookahead admission
# --------------------------------------------------------------------------


def test_lookahead_row_resident_by_its_step_and_never_evicted():
    coll = _coll(vocab=100, cache_ratio=0.12)  # capacity 12; 4 fresh rows a step
    state = coll.init(0, device="cpu")  # warm: rows 0..11 resident
    batches = [[0, 1, 2, 3], [20, 21, 22, 23], [30, 31, 32, 33], [40, 41, 42, 43],
               [50, 51, 52, 53]]
    target = 30  # needed at t=2: prefetched at t=0, pinned at t=1
    residency = []
    for t in range(3):
        fb_now = _fb(batches[t])
        state, addr = coll.prepare_lookahead(state, fb_now, [_fb(b) for b in batches[t + 1 : t + 3]])
        residency.append(_resident(state, target))
        if t == 2:
            assert all(int(a) >= 0 for a in addr["t"])
        _exact(coll, state, addr, fb_now)
    assert residency == [True, True, True], residency


def test_lookahead_current_batch_wins_under_capacity_pressure():
    coll = _coll(vocab=100, cache_ratio=0.06, ids=6)  # capacity 6 = one batch
    state = coll.init(0, device="cpu")
    fb_now = _fb([10, 11, 12, 13, 14, 15])
    state, addr = coll.prepare_lookahead(state, fb_now, [_fb([20, 21, 22, 23, 24, 25])])
    assert all(int(a) >= 0 for a in addr["t"])
    _exact(coll, state, addr, fb_now)


def test_future_only_slab_counts_as_unresident_not_keyerror():
    tables = [col.TableConfig("a", vocab=64, dim=4, ids_per_step=4,
                              placement=col.Placement.CACHED, cache_ratio=0.5),
              col.TableConfig("b", vocab=64, dim=4, ids_per_step=4,
                              placement=col.Placement.CACHED, cache_ratio=0.5)]
    coll = col.EmbeddingCollection(tables, col.PlacementPlanner(10**9).plan(tables))
    state = coll.init(0, device="cpu")
    fb_now = col.FeatureBatch(ids={"a": torch.tensor([1, 2, 3, -1], dtype=torch.int32)})
    fb_fut = col.FeatureBatch(ids={"a": torch.tensor([4, 5, -1, -1], dtype=torch.int32),
                                   "b": torch.tensor([7, 8, 9, -1], dtype=torch.int32)})
    p = coll.plan_prepare(state, fb_now, fb_future=(fb_fut,))
    assert int(p.future_unresident) == 3  # b's three valid lanes
    assert "a" in p.future_addresses[0] and "b" not in p.future_addresses[0]


def _solo(ids, max_u=8):
    tables = [col.TableConfig("t", vocab=100, dim=4, ids_per_step=ids, max_unique_per_step=max_u,
                              cache_ratio=0.3, placement=col.Placement.CACHED)]
    coll = col.EmbeddingCollection(tables, col.PlacementPlanner(10**9).plan(tables))
    return coll, coll.init(0, device="cpu")


def test_overflow_accounting_under_merged_lookahead_ids():
    """``uniq_overflows`` counts the CURRENT batch's overflow only."""
    coll, state = _solo(8)
    window = [_fb(list(range(20, 28))), _fb(list(range(40, 48)))]  # 16 more distinct
    state, _ = coll.prepare_lookahead(state, _fb([1, 1, 2, 2, 3, 3, 4, 4]), window)
    assert int(coll.metrics(state)["uniq_overflows"]) == 0
    coll12, st12 = _solo(12)
    st12, _ = coll12.prepare_lookahead(st12, _fb(list(range(80, 92))),
                                       [_fb(list(range(8)) + [-1] * 4)])
    assert int(coll12.metrics(st12)["uniq_overflows"]) == 1


def test_abandoned_group_pins_are_cleared_by_next_plan():
    """Pins live in one plan: an abandoned group's prefetched rows are all
    reclaimable by the next plan, which stays exact."""
    coll = _coll(vocab=100, cache_ratio=0.06, ids=6)  # capacity 6 = one batch
    state = coll.init(0, device="cpu")  # warm: rows 0..5 resident
    state, _ = coll.prepare_lookahead(state, _fb([0, 1, 2, -1, -1, -1]),
                                      [_fb([20, 21, 22, -1, -1, -1])])
    assert all(_resident(state, r) for r in (20, 21, 22))
    fb = _fb([30, 31, 32, 33, 34, 35])  # needs all 6 slots
    state, addr = coll.prepare(state, fb)
    assert all(int(a) >= 0 for a in addr["t"])
    assert not any(_resident(state, r) for r in (20, 21, 22))
    _exact(coll, state, addr, fb)


@pytest.mark.parametrize("policy", [Policy.LRU, Policy.RUNTIME_LFU])
def test_stale_prefetch_not_above_normal_tier_for_runtime_policies(policy):
    """A prefetched-then-abandoned row competes like any resident row: the
    rows used since outrank it, so it is evicted first."""
    coll = _coll(vocab=100, cache_ratio=0.08, ids=4, policy=policy)  # capacity 8
    state = coll.init(0, device="cpu")
    state, _ = coll.prepare_lookahead(state, _fb([0, 1, -1, -1]), [_fb([20, 21, -1, -1])])
    for ids in ([2, 3, 4, 5], [2, 3, 4, 5]):
        state, _ = coll.prepare(state, _fb(ids))
    state, addr = coll.prepare(state, _fb([40, 41, 42, 43]))
    assert all(int(a) >= 0 for a in addr["t"])
    assert not _resident(state, 20) and not _resident(state, 21)
    assert _resident(state, 2) and _resident(state, 3)


# --------------------------------------------------------------------------
# the pipelined trainer: bitwise the serial one
# --------------------------------------------------------------------------

BASE = dict(embed_dim=8, batch_size=16, cache_ratio=0.25, lr=0.1, bottom_mlp=(16, 8),
            top_mlp=(16,))


def _trainers(cfg, depth, max_steps, make_batch):
    m1, m2 = DLRM(cfg), DLRM(cfg)
    serial = Trainer(TrainerConfig(max_steps=max_steps),
                     init_fn=lambda: m1.init(0, device="cpu"), step_fn=m1.train_step,
                     make_batch=make_batch, flush_fn=m1.flush, device="cpu")
    piped = PipelinedTrainer(TrainerConfig(max_steps=max_steps, pipeline_depth=depth),
                             init_fn=lambda: m2.init(0, device="cpu"), plan_fn=m2.plan_step,
                             compute_fn=m2.compute_step, apply_fn=m2.apply_step,
                             make_batch=make_batch, flush_fn=m2.flush, device="cpu")
    serial.run()
    piped.run()
    return serial.history, piped.history


@pytest.mark.parametrize("pipeline_depth", [1, 3])
def test_pipelined_trainer_loss_bit_identical_to_serial(pipeline_depth):
    cfg = DLRMConfig(vocab_sizes=(4096, 256, 64), **BASE)
    spec = synth.ZipfSparseSpec(vocab_sizes=cfg.vocab_sizes, n_dense=13)
    serial, piped = _trainers(cfg, pipeline_depth, 6,
                              lambda s: synth.sparse_batch(spec, 16, 0, s))
    for key in ("loss", "auc", "step"):
        assert [h[key] for h in serial] == [h[key] for h in piped], key


def test_pipelined_trainer_int8_host_tier_within_codec_noise():
    """With an int8 host tier the pins change which rows are requantized:
    the reference's tolerance."""
    cfg = DLRMConfig(vocab_sizes=(4096, 256, 64), host_precision="int8", **BASE)
    spec = synth.ZipfSparseSpec(vocab_sizes=cfg.vocab_sizes, n_dense=13)
    serial, piped = _trainers(cfg, 3, 6, lambda s: synth.sparse_batch(spec, 16, 0, s))
    np.testing.assert_allclose([h["loss"] for h in piped], [h["loss"] for h in serial], atol=5e-3)


def test_pipelined_trainer_handles_stream_ending_mid_group():
    """A finite stream of 5 batches at depth 3: groups of 3 and a short tail
    of 2, losses bitwise the serial trainer's over the same stream."""
    cfg = DLRMConfig(vocab_sizes=(1024, 128), **BASE)
    spec = synth.ZipfSparseSpec(vocab_sizes=cfg.vocab_sizes, n_dense=13)

    def make_batch(step):
        if step >= 5:
            raise StopIteration
        return synth.sparse_batch(spec, 16, 0, step)

    serial, piped = _trainers(cfg, 3, 50, make_batch)
    assert len(serial) == len(piped) == 5
    assert [h["loss"] for h in serial] == [h["loss"] for h in piped]


def test_pipelined_group_guard_raises_when_the_window_does_not_fit():
    """A group whose rows cannot all be resident at once fails with the
    remedy instead of gathering zero rows."""
    cfg = DLRMConfig(vocab_sizes=(4096,), **dict(BASE, cache_ratio=0.0))  # one batch of slots
    spec = synth.ZipfSparseSpec(vocab_sizes=cfg.vocab_sizes, n_dense=13)
    with pytest.raises(RuntimeError, match="pipeline_depth"):
        _trainers(cfg, 3, 6, lambda s: synth.sparse_batch(spec, 16, 0, s))


# --------------------------------------------------------------------------
# the Prefetcher's lookahead view and end of stream
# --------------------------------------------------------------------------


def test_prefetcher_lookahead_peeks_without_consuming():
    pf = Prefetcher(lambda s: {"x": np.asarray([s])}, start_step=0, depth=4)
    try:
        step, batch = next(pf)
        assert (step, int(batch["x"][0])) == (0, 0)
        assert [s for s, _ in pf.lookahead(3)] == [1, 2, 3]
        assert [s for s, _ in pf.lookahead(3)] == [1, 2, 3]  # nothing consumed
        assert next(pf)[0] == 1
        with pytest.raises(ValueError):
            pf.lookahead(5)  # beyond the buffer's depth
    finally:
        pf.close()


def test_prefetcher_close_joins_worker_thread():
    before = threading.active_count()
    pf = Prefetcher(lambda s: {"x": np.asarray([s])}, depth=2)
    next(pf)
    pf.close()
    assert not pf._thread.is_alive()
    assert threading.active_count() <= before


def test_prefetcher_surfaces_producer_error_in_order():
    def make(step):
        if step == 2:
            raise RuntimeError("boom")
        return {"x": np.asarray([step])}

    pf = Prefetcher(make, depth=2)
    try:
        assert next(pf)[0] == 0
        assert next(pf)[0] == 1
        with pytest.raises(RuntimeError, match="boom"):
            next(pf)
    finally:
        pf.close()
    pf2 = Prefetcher(make, depth=3)
    try:
        assert next(pf2)[0] == 0
        with pytest.raises(RuntimeError, match="boom"):
            pf2.lookahead(3)  # only step 1 exists before the error
        assert next(pf2)[0] == 1  # a buffered batch stays consumable
    finally:
        pf2.close()


def _finite(n):
    def make(step):
        if step >= n:
            raise StopIteration
        return {"x": np.asarray([step])}
    return make


def test_prefetcher_lookahead_short_list_means_stream_ended():
    pf = Prefetcher(_finite(3), depth=4)
    try:
        assert next(pf)[0] == 0
        assert [s for s, _ in pf.lookahead(4)] == [1, 2]
        assert pf.exhausted
        assert next(pf)[0] == 1
        assert next(pf)[0] == 2
        with pytest.raises(StopIteration):
            next(pf)
        assert pf.lookahead(2) == []
    finally:
        pf.close()
    assert pf.lookahead(2) == []  # an ended stream keeps the contract after close()


def test_prefetcher_iteration_ends_cleanly_on_finite_stream():
    pf = Prefetcher(_finite(4), depth=2)
    try:
        assert [s for s, _ in pf] == [0, 1, 2, 3]
        assert pf.exhausted
    finally:
        pf.close()


def test_prefetcher_lookahead_on_closed_raises():
    pf = Prefetcher(lambda s: {"x": np.asarray([s])}, depth=2)
    next(pf)
    pf.close()
    with pytest.raises(RuntimeError, match="closed"):
        pf.lookahead(1)
