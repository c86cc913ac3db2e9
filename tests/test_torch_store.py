"""The port's host tier (``store/host_store.py``, ``store/codec.py``,
``store/policy.py``) against ``repro.store``: codec round trips and
bounds, encoded accounting, evict / reload stability, the oracle after
updates, encoded checkpoints, ``PrecisionPolicy`` and "auto" resolved at
init, BENCH_PR3's wire bytes, and BENCH_PR9's equal-budget rows, hit
rates and loss.

Tolerances: the codecs, the encoded stores and every state moved by an
eager reference with one transmitter round are compared bitwise; the
policy's picks and the accounting are exact integers and strings.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_tree_equal, jax_to_numpy

from repro.core import collection as jcol
from repro.store import HostStore as JHostStore
from repro.store import PrecisionPolicy as JPrecisionPolicy
from repro.store import SlabGeometry as JSlabGeometry
from repro.store import get_codec as jget_codec
from repro_torch import convert
from repro_torch.core import cache as cache_lib
from repro_torch.core import collection as col
from repro_torch.store import HostStore, PrecisionPolicy, SlabGeometry, get_codec
from repro_torch.store.arena import tiered_arena_bytes
from repro_torch.train import checkpoint as C

CODECS = ["fp32", "fp16", "int8"]


def _rows(n=32, d=16, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(n, d)) * scale).astype(np.float32)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --------------------------------------------------------------------------
# codecs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("codec", CODECS)
def test_codec_encode_decode_match_reference(codec):
    x = _rows(64, 24, seed=1, scale=3.0)
    x[3] = 0.25  # a constant row: the scale's epsilon floor
    jp, js = jget_codec(codec).encode(jnp.asarray(x))
    tp, ts = get_codec(codec).encode(torch.from_numpy(x))
    assert np.array_equal(_np(tp), np.asarray(jp)) and _np(tp).dtype == np.asarray(jp).dtype
    assert (ts is None) == (js is None)
    if ts is not None:
        assert np.array_equal(_np(ts), np.asarray(js))
    jy = jget_codec(codec).decode(jp, js, jnp.float32)
    ty = get_codec(codec).decode(tp, ts, torch.float32)
    assert np.array_equal(_np(ty), np.asarray(jy))


def test_codec_error_bounds():
    x = torch.from_numpy(_rows(scale=3.0))
    p, s = get_codec("fp32").encode(x)
    assert s is None and torch.equal(get_codec("fp32").decode(p, s, torch.float32), x)
    p, s = get_codec("fp16").encode(x)
    assert p.dtype == torch.float16 and s is None
    torch.testing.assert_close(get_codec("fp16").decode(p, s, torch.float32), x,
                               rtol=2**-11, atol=1e-7)
    x = torch.from_numpy(_rows(scale=2.0))
    p, s = get_codec("int8").encode(x)
    assert p.dtype == torch.int8 and s.shape == (x.shape[0], 2)
    y = get_codec("int8").decode(p, s, torch.float32)
    step = (x.amax(1) - x.amin(1)) / 254.0  # affine row-wise: half a step per row
    assert bool(((y - x).abs() <= step[:, None] * 0.5 + 1e-6).all())


def test_int8_constant_row_and_projection_stability():
    c = get_codec("int8")
    p, s = c.encode(torch.full((3, 5), 0.25))
    torch.testing.assert_close(c.decode(p, s, torch.float32), torch.full((3, 5), 0.25),
                               rtol=0, atol=1e-6)
    x = torch.from_numpy(_rows(seed=3))
    p1, s1 = c.encode(x)
    y1 = c.decode(p1, s1, torch.float32)
    p2, s2 = c.encode(y1)
    assert torch.equal(p1, p2)  # decode -> encode is a stable projection
    torch.testing.assert_close(c.decode(p2, s2, torch.float32), y1, rtol=0, atol=1e-6)


# --------------------------------------------------------------------------
# the store
# --------------------------------------------------------------------------


@pytest.mark.parametrize("codec", CODECS)
def test_host_store_matches_reference(codec):
    w = _rows(64, 16, seed=2)
    accum = np.random.default_rng(5).random(64).astype(np.float32)
    js = JHostStore.create({"weight": jnp.asarray(w), "accum": jnp.asarray(accum)}, codec)
    ts = HostStore.create({"weight": torch.from_numpy(w.copy()),
                           "accum": torch.from_numpy(accum.copy())}, codec)
    want, got = jax_to_numpy(js), convert.to_numpy(ts)
    assert_tree_equal(want, got, "store")
    assert ts.data["accum"].dtype == torch.float32  # a per-row scalar stays raw
    for key in ("weight", "accum"):
        assert ts.is_encoded(key) == js.is_encoded(key)
        assert np.array_equal(_np(ts.decode_leaf(key)), np.asarray(js.decode_leaf(key)))
    idx = np.array([5, -1, 63, 64, 0, 17], np.int32)  # -1 and out of range: zero rows
    jr = js.decode_rows(jnp.asarray(idx))
    tr = ts.decode_rows(torch.from_numpy(idx))
    for key in jr:
        assert np.array_equal(_np(tr[key]), np.asarray(jr[key])), key
    assert ts.row_wire_bytes() == js.row_wire_bytes()
    assert ts.host_bytes() == js.host_bytes()
    assert ts.fp32_equiv_bytes() == js.fp32_equiv_bytes()
    assert ts.bytes_saved() == js.bytes_saved()


def test_host_store_accounting():
    full = {"weight": torch.from_numpy(_rows(64, 16)), "accum": torch.zeros((64,))}
    st8, st32 = HostStore.create(full, "int8"), HostStore.create(full, "fp32")
    assert st8.row_wire_bytes() == 16 + 8 + 4  # payload + sideband + the raw accum
    assert st32.row_wire_bytes() == 64 + 4
    assert st8.bytes_saved() == st32.host_bytes() - st8.host_bytes() > 0


def test_host_store_rejects_mixed_encoded_dtypes():
    full = {"w32": torch.from_numpy(_rows(8, 4)),
            "w16": torch.from_numpy(_rows(8, 4)).to(torch.float16)}
    with pytest.raises(ValueError, match="one decode dtype"):
        HostStore.create(full, "int8")


@pytest.mark.parametrize("codec", CODECS)
def test_allocate_and_write_rows_equal_create(codec):
    """The init path (chunks encoded where they were drawn) builds the same
    store as encoding the whole table at once."""
    w = torch.from_numpy(_rows(70, 8, seed=4))
    want = HostStore.create({"weight": w.clone()}, codec)
    got = HostStore.allocate({"weight": ((70, 8), torch.float32)}, codec)
    for r0 in range(0, 70, 32):
        got.write_rows(r0, {"weight": w[r0 : r0 + 32]})
    assert_tree_equal(convert.to_numpy(want), convert.to_numpy(got), "store")


def test_fp32_store_bit_identical_to_raw_tree():
    cfg = cache_lib.CacheConfig(vocab=60, capacity=12, ids_per_step=8, buffer_rows=5)
    w = torch.from_numpy(_rows(60, 8, seed=1))
    raw = {"weight": w.clone()}
    store = HostStore.create({"weight": w.clone()}, "fp32")
    cpu = torch.device("cpu")
    st_a = cache_lib.init_cache(cfg, {"weight": torch.zeros((8,))}, cpu)
    st_b = cache_lib.init_cache(cfg, {"weight": torch.zeros((8,))}, cpu)
    rng = np.random.default_rng(0)
    for _ in range(12):
        ids = torch.from_numpy(rng.integers(0, 60, 8).astype(np.int32))
        raw, st_a, slots_a = cache_lib.prepare(cfg, raw, st_a, ids)
        store, st_b, slots_b = cache_lib.prepare(cfg, store, st_b, ids)
        assert torch.equal(slots_a, slots_b)
        assert torch.equal(st_a.cached_rows["weight"], st_b.cached_rows["weight"])
        g = torch.from_numpy(rng.normal(size=(12, 8)).astype(np.float32))
        st_a.cached_rows["weight"].add_(g)
        st_b.cached_rows["weight"].add_(g)
    raw, st_a = cache_lib.flush(cfg, raw, st_a)
    store, st_b = cache_lib.flush(cfg, store, st_b)
    assert torch.equal(raw["weight"], store["weight"])


# --------------------------------------------------------------------------
# through the collection: evict / reload, the oracle, parity
# --------------------------------------------------------------------------


def _one_table(codec, vocab=64, dim=8, ids=8, ratio=0.01, buffer_rows=4, **kw):
    tables = [col.TableConfig("t", vocab=vocab, dim=dim, ids_per_step=ids)]
    return col.EmbeddingCollection.create(tables, cache_ratio=ratio, buffer_rows=buffer_rows,
                                          host_precision=codec, **kw)


def _fb(ids):
    return col.FeatureBatch(ids={"t": torch.as_tensor(ids, dtype=torch.int32)})


@pytest.mark.parametrize("codec", ["fp16", "int8"])
def test_evict_reload_idempotent_for_untouched_rows(codec):
    coll = _one_table(codec)  # capacity 8, two rounds of 4 per move
    st = coll.init(0, warm=False, device="cpu")
    ids_a, ids_b = np.arange(8), np.arange(8, 16)
    st, _, rows = coll.lookup(st, _fb(ids_a))
    v1 = rows["t"].clone()
    payload, vals = [], []
    for _ in range(3):  # evict A (encode) / reload A (decode), three cycles
        st, _ = coll.prepare(st, _fb(ids_b))
        payload.append(st.slabs[col.SHARED_ARENA].full.data["weight"][:8].clone())
        st, _, rows = coll.lookup(st, _fb(ids_a))
        vals.append(rows["t"].clone())
    assert torch.equal(payload[0], payload[1]) and torch.equal(payload[1], payload[2])
    torch.testing.assert_close(vals[0], vals[1], rtol=0, atol=1e-6)
    torch.testing.assert_close(vals[1], vals[2], rtol=0, atol=1e-6)
    torch.testing.assert_close(v1, vals[0], rtol=0, atol=1e-5)


def test_fp32_evict_reload_bit_exact():
    coll = _one_table("fp32")
    st = coll.init(0, warm=False, device="cpu")
    st, _, rows = coll.lookup(st, _fb(np.arange(8)))
    v1 = rows["t"].clone()
    st, _ = coll.prepare(st, _fb(np.arange(8, 16)))
    st, _, rows = coll.lookup(st, _fb(np.arange(8)))
    assert torch.equal(v1, rows["t"])


@pytest.mark.parametrize("codec", ["fp16", "int8"])
def test_quantized_store_matches_oracle_after_updates(codec):
    tables = [col.TableConfig("a", vocab=50, dim=8, ids_per_step=6),
              col.TableConfig("b", vocab=30, dim=8, ids_per_step=6)]
    coll = col.EmbeddingCollection.create(tables, cache_ratio=0.2, buffer_rows=5,
                                          host_precision=codec)
    st = coll.init(0, device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(6):
        fb = col.FeatureBatch(ids={"a": torch.from_numpy(rng.integers(0, 50, 6).astype(np.int32)),
                                   "b": torch.from_numpy(rng.integers(0, 30, 6).astype(np.int32))})
        st, _, _ = coll.lookup(st, fb)
        st = coll.apply_grads(st, {col.SHARED_ARENA: torch.ones((16, 8))}, 0.01)
    flushed = coll.flush(st)
    ref = coll.dense_reference(flushed, fb)
    _, _, rows = coll.lookup(flushed, fb)
    atol = 0.01 if codec == "int8" else 1e-3  # one quantization step
    for f in fb.features:
        torch.testing.assert_close(rows[f], ref[f], rtol=0, atol=atol)


def _jax_pair(codec, arena="fp32", ratio=0.1, vocab=96, dim=8, ids=16, warm=True):
    """The reference and the port on one table from the reference's state
    (one transmitter round per move: buffer_rows >= every move's lanes)."""
    jt = [jcol.TableConfig("t", vocab=vocab, dim=dim, ids_per_step=ids)]
    tt = [col.TableConfig("t", vocab=vocab, dim=dim, ids_per_step=ids)]
    kw = dict(cache_ratio=ratio, host_precision=codec, arena_precision=arena)
    jc, tc = jcol.EmbeddingCollection.create(jt, **kw), col.EmbeddingCollection.create(tt, **kw)
    js = jc.init(jax.random.PRNGKey(0), warm=warm)
    ts = convert.collection_state_from_numpy(jax_to_numpy(js), device="cpu", collection=tc)
    return (jc, js), (tc, ts)


@pytest.mark.parametrize("codec,arena", [("fp16", "fp32"), ("int8", "fp32"), ("int8", "int8"),
                                         ("fp16", "fp16"), ("int8", "fp16")])
def test_encoded_host_tier_moves_match_reference_bitwise(codec, arena):
    """Loads (decode on arrival, or the verbatim host -> tail path when the
    codecs match), SGD, write-backs (encode) and the flush: the index state,
    the arena and the host payload and sideband bitwise the eager
    reference's; the counters and wire bytes exact."""
    (jc, js), (tc, ts) = _jax_pair(codec, arena)
    rng = np.random.default_rng(1)
    for step in range(6):
        ids = (rng.zipf(1.3, 16) % 96).astype(np.int32)
        ids[rng.random(16) < 0.1] = -1
        js, _ = jc.prepare(js, jcol.FeatureBatch(ids={"t": jnp.asarray(ids)}))
        ts, _ = tc.prepare(ts, _fb(ids))
        g = rng.normal(size=(tc.cached_slabs[col.SHARED_ARENA].capacity, 8)).astype(np.float32)
        js = jc.apply_grads(js, {jcol.SHARED_ARENA: jnp.asarray(g)}, 0.05)
        ts = tc.apply_grads(ts, {col.SHARED_ARENA: torch.from_numpy(g)}, 0.05)
        want, got = jax_to_numpy(js), convert.to_numpy(ts)
        assert_tree_equal(want, got, f"step {step}")
        jm, tm = jc.metrics(js), tc.metrics(ts)
        for key in ("cache_misses", "cache_evictions"):
            assert int(tm[key]) == int(jm[key]), key
        assert (jcol.exact_metric_bytes(jm, "host_moved_rows", "host_row_bytes")
                == sum(int(tm["host_moved_rows"][k]) * int(tm["host_row_bytes"][k])
                       for k in tm["host_moved_rows"]))
    assert int(tm["cache_evictions"]) > 0
    assert_tree_equal(jax_to_numpy(jc.flush(js)), convert.to_numpy(tc.flush(ts)), "flushed")


# --------------------------------------------------------------------------
# checkpoints persist the ENCODED store and validate its codec
# --------------------------------------------------------------------------


def test_checkpoint_roundtrips_encoded_store(tmp_path):
    coll = _one_table("int8", ratio=0.25, buffer_rows=65536)
    st = coll.init(0, device="cpu")
    st, _ = coll.prepare(st, _fb(np.arange(8)))
    st = coll.flush(st)
    C.save(tmp_path, 3, st)
    like = coll.init(1, device="cpu")
    restored, step = C.restore(tmp_path, like)
    assert step == 3
    full, want = restored.slabs[col.SHARED_ARENA].full, st.slabs[col.SHARED_ARENA].full
    assert full.data["weight"].dtype == torch.int8
    assert torch.equal(full.data["weight"], want.data["weight"])
    assert torch.equal(full.sideband["weight"], want.sideband["weight"])


@pytest.mark.parametrize("saved,template", [("int8", "fp16"), ("int8", "fp32"),
                                            ("fp32", "int8")])
def test_checkpoint_codec_mismatch_raises(tmp_path, saved, template):
    C.save(tmp_path, 1, _one_table(saved, ratio=0.25).init(0, device="cpu"))
    like = _one_table(template, ratio=0.25).init(0, device="cpu")
    with pytest.raises(ValueError, match="host"):
        C.restore(tmp_path, like)


def test_checkpoint_shape_mismatch_raises(tmp_path):
    C.save(tmp_path, 1, {"x": torch.zeros((4,))})
    with pytest.raises(ValueError, match="mismatch"):
        C.restore(tmp_path, {"x": torch.zeros((5,))})


# --------------------------------------------------------------------------
# precision policy
# --------------------------------------------------------------------------


def test_precision_policy_coverage_thresholds():
    pol = PrecisionPolicy()
    g = SlabGeometry(name="t", vocab=1000, dim=16, capacity=100)
    hot = np.zeros(1000)
    hot[:100], hot[100:] = 1000.0, 0.1
    assert pol.choose(g, hot) == "int8"
    assert pol.choose(g, np.ones(1000)) == "fp32"
    assert pol.choose(g, None) == pol.no_stats == "fp16"


def test_precision_policy_budget_demotes_coldest_first():
    pol = PrecisionPolicy()
    hot = SlabGeometry(name="hot", vocab=1000, dim=16, capacity=500)
    cold = SlabGeometry(name="cold", vocab=1000, dim=16, capacity=10)
    skew = np.r_[np.full(500, 100.0), np.ones(500)]
    counts = {"hot": skew, "cold": np.ones(1000)}
    assert pol.assign([hot, cold], counts)["cold"] == "fp32"
    assert pol.assign([hot, cold], counts, host_budget_bytes=2 * 1000 * 24)["cold"] != "fp32"
    with pytest.raises(ValueError, match="int8"):
        pol.assign([hot, cold], counts, host_budget_bytes=100)


def test_precision_policy_budget_demotes_best_covered_first():
    pol = PrecisionPolicy()
    a = SlabGeometry(name="a", vocab=1000, dim=16, capacity=100)
    b = SlabGeometry(name="b", vocab=1000, dim=16, capacity=100)
    counts = {"a": np.r_[np.full(100, 0.45), np.full(900, 55.0 / 900)],
              "b": np.r_[np.full(100, 0.70), np.full(900, 30.0 / 900)]}
    assert pol.assign([a, b], counts) == {"a": "fp16", "b": "fp16"}
    tight = pol.assign([a, b], counts, host_budget_bytes=1000 * 32 + 1000 * 24)
    assert tight == {"a": "fp16", "b": "int8"}


@pytest.mark.parametrize("seed", range(4))
def test_precision_policy_matches_reference(seed):
    rng = np.random.default_rng(seed)
    geoms = [(f"s{i}", int(rng.integers(50, 2000)), int(rng.choice([8, 16, 32])))
             for i in range(5)]
    counts = {n: rng.zipf(1.1 + 0.3 * rng.random(), v).astype(np.float64) * (rng.random() < 0.8)
              for n, v, _ in geoms}
    tg = [SlabGeometry(n, v, d, capacity=max(1, v // 10)) for n, v, d in geoms]
    jg = [JSlabGeometry(n, v, d, capacity=max(1, v // 10)) for n, v, d in geoms]
    tp, jp = PrecisionPolicy(), JPrecisionPolicy()
    for t, j in zip(tg, jg):
        assert tp.choose(t, counts[t.name]) == jp.choose(j, counts[j.name])
        assert tp.choose_arena(t, t.capacity // 4, counts[t.name]) == jp.choose_arena(
            j, j.capacity // 4, counts[j.name])
    total = sum(v * d * 4 for _, v, d in geoms)
    for budget in (None, total, total // 2, total // 3, total // 5):
        try:
            want = jp.assign(jg, counts, budget)
        except ValueError as e:  # even int8 does not fit: both refuse
            with pytest.raises(ValueError, match="int8"):
                tp.assign(tg, counts, budget)
            assert "int8" in str(e)
            continue
        assert tp.assign(tg, counts, budget) == want


@pytest.mark.parametrize("which", ["host", "arena"])
def test_auto_precision_resolves_at_init_like_the_reference(which):
    z = np.random.default_rng(0).zipf(1.6, 100_000) % 512
    counts = {"t": np.bincount(z, minlength=512)}
    kw = {f"{which}_precision": "auto"}
    jc = jcol.EmbeddingCollection.create(
        [jcol.TableConfig("t", vocab=512, dim=8, ids_per_step=16)], cache_ratio=0.25, **kw)
    tc = col.EmbeddingCollection.create(
        [col.TableConfig("t", vocab=512, dim=8, ids_per_step=16)], cache_ratio=0.25, **kw)
    js = jc.init(jax.random.PRNGKey(0), counts=counts)
    ts = tc.init(0, counts=counts, device="cpu")
    want = getattr(jc, f"{which}_precision")[jcol.SHARED_ARENA]
    got = getattr(tc, f"{which}_precision")[col.SHARED_ARENA]
    assert got == want and got in ("fp16", "int8")
    slab = ts.slabs[col.SHARED_ARENA]
    assert slab.full.codec == js.slabs[jcol.SHARED_ARENA].full.codec
    arena = slab.cache.cached_rows
    assert (arena.codec if which == "arena" else "fp32") == tc.arena_precision[col.SHARED_ARENA]
    assert tc.cached_slabs[col.SHARED_ARENA].cache_config().arena_precision == \
        tc.arena_precision[col.SHARED_ARENA]
    # no counts: the policy's no-stats pick
    tc2 = col.EmbeddingCollection.create(
        [col.TableConfig("t", vocab=512, dim=8, ids_per_step=16)], cache_ratio=0.25, **kw)
    tc2.init(0, device="cpu")
    assert getattr(tc2, f"{which}_precision")[col.SHARED_ARENA] == "fp16"


def test_metrics_writeback_false_counts_loads_only():
    coll = _one_table("fp32", buffer_rows=65536)  # capacity 8
    state = coll.init(0, warm=False, device="cpu")
    for lo in (0, 8, 16):
        state, _ = coll.prepare(state, _fb(np.arange(lo, lo + 8)), writeback=False)
    m_rw, m_ro = coll.metrics(state), coll.metrics(state, writeback=False)
    misses, evs = float(m_ro["cache_misses"]), float(m_ro["cache_evictions"])
    assert evs > 0
    assert float(m_ro["host_wire_bytes"]) == misses * 8 * 4
    assert float(m_rw["host_wire_bytes"]) == (misses + evs) * 8 * 4


def test_collect_counts_stream_matches_reference():
    from repro.core import freq as jfreq
    from repro_torch.core import freq

    rng = np.random.default_rng(3)
    batches = [{"a": rng.integers(-1, 40, 32).astype(np.int32),
                "b": rng.integers(-1, 20, (4, 8)).astype(np.int32),
                "label": np.zeros(32, np.int32)} for _ in range(6)]
    routes, vocabs = {"a": "ta", "b": "tb"}, {"ta": 40, "tb": 20}
    want = jfreq.collect_counts_stream(iter(batches), routes, vocabs, max_batches=5)
    got = freq.collect_counts_stream(
        iter([{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]), routes,
        vocabs, max_batches=5)
    assert want.keys() == got.keys()
    for k in want:
        assert np.array_equal(want[k], got[k])


# --------------------------------------------------------------------------
# the benchmarks' hardware-independent numbers
# --------------------------------------------------------------------------


def _dlrm_losses(host_precision, steps, vocabs=(256, 128, 64), batch=16, **kw):
    from repro_torch.data import synth
    from repro_torch.models.dlrm import DLRM, DLRMConfig

    cfg = DLRMConfig(vocab_sizes=vocabs, embed_dim=kw.pop("embed_dim", 8), batch_size=batch,
                     cache_ratio=kw.pop("cache_ratio", 0.15), lr=0.1,
                     bottom_mlp=kw.pop("bottom_mlp", (16, 8)), top_mlp=kw.pop("top_mlp", (16,)),
                     host_precision=host_precision, use_pallas_plan=True, **kw)
    model = DLRM(cfg)
    spec = synth.ZipfSparseSpec(vocab_sizes=cfg.vocab_sizes, n_dense=13)
    state = model.init(0, device="cpu")
    losses, metrics = [], []
    for s in range(steps):
        b = {k: torch.from_numpy(v) for k, v in synth.sparse_batch(spec, batch, 0, s).items()}
        state, m = model.train_step(state, b)
        losses.append(float(m["loss"]))
        metrics.append(m)
    return losses, state, metrics


def test_int8_dlrm_trains_to_loss_parity():
    ref, _, _ = _dlrm_losses("fp32", 25)
    got, state, _ = _dlrm_losses("int8", 25)
    assert np.mean(got[-5:]) < np.mean(got[:5])
    assert abs(np.mean(got[-5:]) - np.mean(ref[-5:])) < 0.05
    slab = state["emb"].slabs[col.SHARED_ARENA]
    assert slab.full.codec == "int8" and slab.full.data["weight"].dtype == torch.int8
    assert slab.full.row_wire_bytes() == 8 + 8 < 8 * 4


def test_fp32_dlrm_loss_identical_across_runs():
    a, _, _ = _dlrm_losses("fp32", 8)
    b, _, _ = _dlrm_losses("fp32", 8)
    assert a == b


def test_bench_pr3_wire_bytes_per_step():
    """BENCH_PR3 (``bench_cache_ops.bench_host_store``, non-SMOKE): the
    cache bookkeeping is value-independent, so the three host codecs see one
    miss / eviction trace and the wire bytes a step are the encoded row
    size times the rows moved: 0.677 / 0.339 / 0.212 MB, 2.00x and 3.20x
    less than fp32 (``BENCH_PR3.json``), from the exact counters."""
    per_step = {}
    for codec in CODECS:
        _, _, ms = _dlrm_losses(codec, 13, vocabs=(500_000, 200_000, 100_000, 50_000),
                                batch=4096, embed_dim=32, cache_ratio=0.05,
                                bottom_mlp=(64, 32), top_mlp=(64,))

        def exact(m):
            return sum(int(m["host_moved_rows"][k]) * int(m["host_row_bytes"][k])
                       for k in m["host_moved_rows"])

        per_step[codec] = (exact(ms[-1]) - exact(ms[0])) / 12
    assert {c: round(v / 1e6, 3) for c, v in per_step.items()} == {
        "fp32": 0.677, "fp16": 0.339, "int8": 0.212}
    assert round(per_step["fp32"] / per_step["fp16"], 2) == 2.00
    assert round(per_step["fp32"] / per_step["int8"], 2) == 3.20


def test_bench_pr9_equal_budget_resident_rows():
    """BENCH_PR9 (``bench_cache_ops.bench_arena_precision``, non-SMOKE): the
    byte budget of 10 000 fp32 rows of dim 64 holds 18 182 rows with an fp16
    tail and 28 318 with an int8 tail (fp32 head 10 %)."""
    vocab, dim, head_ratio = 500_000, 64, 0.1
    base_cap = int(0.02 * vocab)
    budget = base_cap * dim * 4

    def rows_for_budget(codec):
        if codec == "fp32":
            return base_cap

        def bytes_at(c):
            head = min(c, max(1, int(round(head_ratio * c))))
            return tiered_arena_bytes(c, head, dim, torch.float32, codec)

        c = base_cap
        while bytes_at(c + 1) <= budget and c < vocab:
            c += 1
        return c

    assert [rows_for_budget(c) for c in CODECS] == [10_000, 18_182, 28_318]


@pytest.mark.parametrize("codec", CODECS)
def test_bench_pr9_hit_rates_and_loss_match_reference(codec):
    """BENCH_PR9's full shape (vocab 500 000, dim 64, batch 4096, a warm-up
    step and 12 steps, fp32 head 10 %, the arena re-sized per codec to the
    budget of 10 000 fp32 rows): from the reference's converted init, the
    port's hits and misses equal the jitted reference's (hit rates 0.9076 /
    0.9276 / 0.9405, as in BENCH_PR9.json) and its final loss is within
    rtol 1e-5 of the reference's (0.6332 at this tree; BENCH_PR9's 0.6283
    was taken on an older tree)."""
    from repro.models.dlrm import DLRM as JDLRM
    from repro.models.dlrm import DLRMConfig as JDLRMConfig
    from repro_torch.data import synth
    from repro_torch.models.dlrm import DLRM, DLRMConfig

    vocab, dim, batch, steps = 500_000, 64, 4096, 12
    cap = {"fp32": 10_000, "fp16": 18_182, "int8": 28_318}[codec]
    kw = dict(vocab_sizes=(vocab,), embed_dim=dim, batch_size=batch, cache_ratio=cap / vocab,
              lr=0.1, bottom_mlp=(64, dim), top_mlp=(64,), arena_precision=codec,
              arena_head_ratio=0.1)
    jmodel, model = JDLRM(JDLRMConfig(**kw)), DLRM(DLRMConfig(**kw))
    jstate = jmodel.init(jax.random.PRNGKey(0))
    state = convert.state_from_numpy(jax_to_numpy(jstate), device="cpu",
                                     collection=model.collection)
    spec = synth.ZipfSparseSpec(vocab_sizes=(vocab,), n_dense=13)
    jstep = jax.jit(jmodel.train_step)
    for s in range(steps + 1):
        b = synth.sparse_batch(spec, batch, 0, s)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = model.train_step(state, {k: torch.from_numpy(v) for k, v in b.items()})
    jmet, met = jmodel.collection.metrics(jstate["emb"]), model.collection.metrics(state["emb"])
    for key in ("slab_hits", "slab_misses"):
        assert {k: int(v) for k, v in met[key].items()} == \
            {k: int(v) for k, v in jmet[key].items()}, key
    hit = float(met["hit_rate"])
    assert round(hit, 4) == {"fp32": 0.9076, "fp16": 0.9276, "int8": 0.9405}[codec]
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5, atol=0)


def test_dataclass_fields_carry_over():
    """The port's store keeps the reference's field names (``convert`` and
    the checkpoint keys rely on them)."""
    names = {f.name for f in dataclasses.fields(HostStore) if not f.name.startswith("_")}
    assert {f.name for f in dataclasses.fields(JHostStore)} <= names
