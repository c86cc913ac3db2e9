"""The port's embedding bag against the JAX package: the op (forward and
backward) on ``test_kernels.py``'s sweep and ``test_pipeline.py``'s
truncation case, ``nn.embedding_bag``'s combiners, and
``EmbeddingCollection.pool`` over bag features on a collection state
carried across by ``repro_torch.convert``.

The JAX side runs as its own tests run it (Pallas in interpret mode on the
CPU).  Tolerances: the sweep fp32 within 1e-5 and bf16 within 3e-2 (its
own tolerances; both sides accumulate in the table's dtype); ``pool``
forward within rtol 1e-6 and gradients within rtol 1e-5
(``test_pipeline.py``'s); cache addresses bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_tree_equal, jax_to_numpy

from repro.core import collection as jcol
from repro.kernels.embedding_bag import ops as jeb_ops
from repro.kernels.embedding_bag.ref import embedding_bag_ref as jbag_ref
from repro.nn.embedding_bag import embedding_bag as jnn_bag
from repro_torch import convert
from repro_torch.core import collection as col
from repro_torch.kernels.embedding_bag import kernel, ops, ref
from repro_torch.nn import embedding_bag as nn_bag

BF16 = jnp.bfloat16


def _sweep_inputs(v, d, n, s):
    rng = np.random.default_rng(v + n)
    table = rng.normal(size=(v, d)).astype(np.float32)
    seg = np.sort(rng.integers(0, s, n)).astype(np.int32)
    ids = rng.integers(-1, v, n).astype(np.int32)
    return table, ids, seg, int(np.bincount(seg, minlength=s).max())


@pytest.mark.parametrize("v,d,n,s", [(64, 512, 40, 10), (128, 1024, 100, 7), (32, 256, 16, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_bag_sweep_matches_reference(v, d, n, s, dtype, combiner):
    table, ids, seg, mb = _sweep_inputs(v, d, n, s)
    jtable = jnp.asarray(table).astype(BF16 if dtype == "bfloat16" else jnp.float32)
    want = jeb_ops.embedding_bag(jtable, jnp.asarray(ids), jnp.asarray(seg), s, combiner,
                                 max_bag=mb)
    want_ref = jbag_ref(jtable, jnp.asarray(ids), jnp.asarray(seg), s, combiner)
    ttable = torch.from_numpy(np.array(jtable.astype(jnp.float32))).to(getattr(torch, dtype))
    tids, tseg = torch.from_numpy(ids), torch.from_numpy(seg)
    got = ops.embedding_bag(ttable, tids, tseg, s, combiner, max_bag=mb)
    assert got.dtype == ttable.dtype and got.shape == (s, d)
    tol = 1e-5 if dtype == "float32" else 3e-2
    for w in (want, want_ref):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(w, np.float32), rtol=tol,
                                   atol=tol)
    # the oracle twin sums with index_add_, which on the CPU accumulates bf16
    # in fp32 (XLA's scatter-add rounds after every add): in bf16 it equals
    # the reference oracle on the fp32 upcast, rounded once
    got_ref = ref.embedding_bag_ref(ttable, tids, tseg, s, combiner)
    if dtype == "bfloat16":
        want_ref = jbag_ref(jtable.astype(jnp.float32), jnp.asarray(ids), jnp.asarray(seg), s,
                            combiner).astype(BF16)
    np.testing.assert_allclose(got_ref.float().numpy(), np.asarray(want_ref, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_bag_grad_respects_max_bag_truncation(combiner):
    """``test_pipeline.py``'s case: one bag of six lanes truncated at four;
    the backward uses the forward's lane mask and kept count."""
    table = np.arange(40, dtype=np.float32).reshape(10, 4)
    flat = np.arange(6, dtype=np.int32)
    seg = np.zeros(6, np.int32)

    def jloss(w):
        return jnp.sum(jeb_ops.embedding_bag(w, jnp.asarray(flat), jnp.asarray(seg), 1,
                                             combiner=combiner, max_bag=4) ** 2)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(table)))
    w = torch.from_numpy(table).requires_grad_()
    loss = torch.sum(ops.embedding_bag(w, torch.from_numpy(flat), torch.from_numpy(seg), 1,
                                       combiner=combiner, max_bag=4) ** 2)
    (got,) = torch.autograd.grad(loss, [w])
    assert (got[4:6] == 0).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_bag_edges_match_reference_forward_and_grad():
    """Empty segments, -1 and -2 lanes, D % 4 != 0, bags longer than
    max_bag (a -1 lane inside the first max_bag still uses a position):
    the op equals the JAX op, forward and gradient, and its kernel's plain
    version equals its forward bitwise.  Ids >= V (which the cache never
    sends) give zero rows that count for the mean, as ``embedding_bag_ref``
    has it; the reference's Pallas op clamps them to row V-1 instead, so
    they are held to ``embedding_bag_ref`` and to the reference's backward,
    which drops them."""
    rng = np.random.default_rng(7)
    v, d, s = 20, 6, 9
    seg = np.sort(rng.choice([0, 1, 1, 3, 3, 3, 3, 3, 3, 6, 8, 8], size=30)).astype(np.int32)
    table = rng.normal(size=(v, d)).astype(np.float32)
    g = rng.normal(size=(s, d)).astype(np.float32)
    for hi in (v, v + 3):  # in-range ids only, then some ids >= V
        ids = rng.integers(-2, hi, size=30).astype(np.int32)
        targs = (torch.from_numpy(ids), torch.from_numpy(seg), s)
        for combiner in ("sum", "mean"):
            for mb in (2, 5, 0):
                def jloss(w, combiner=combiner, mb=mb, ids=ids):
                    out = jeb_ops.embedding_bag(w, jnp.asarray(ids), jnp.asarray(seg), s,
                                                combiner=combiner, max_bag=mb)
                    return jnp.sum(out * g), out

                (_, want), want_g = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(table))
                if hi > v:
                    want = jbag_ref(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(seg), s,
                                    combiner) if mb == 0 else None
                w = torch.from_numpy(table).requires_grad_()
                out = ops.embedding_bag(w, *targs, combiner=combiner, max_bag=mb)
                (got_g,) = torch.autograd.grad(torch.sum(out * torch.from_numpy(g)), [w])
                if want is not None:
                    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                                               rtol=1e-6, atol=1e-6)
                np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-5,
                                           atol=1e-6)
                plain = kernel.embedding_bag_plain(torch.from_numpy(table), *targs, combiner, mb)
                assert torch.equal(plain, out.detach())


@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
def test_nn_embedding_bag_matches_reference(combiner):
    rng = np.random.default_rng(1)
    table = rng.normal(size=(50, 12)).astype(np.float32)
    ids = np.array([3, 7, -1, 4, 9, 9, -1, -1, 12, 60], np.int32)
    seg = np.array([0, 0, 1, 1, 2, 2, 3, 3, 5, 5], np.int32)  # bag 4 empty, 3 all padding
    wts = rng.random(10).astype(np.float32)
    targs = (torch.from_numpy(table), torch.from_numpy(ids), torch.from_numpy(seg), 6)
    jargs = (jnp.asarray(table), jnp.asarray(ids), jnp.asarray(seg), 6)
    for weights in (None, wts):
        want = jnn_bag(*jargs, combiner=combiner,
                       weights=None if weights is None else jnp.asarray(weights))
        got = nn_bag.embedding_bag(*targs, combiner=combiner,
                                   weights=None if weights is None else torch.from_numpy(weights))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    if combiner != "max":
        got = nn_bag.embedding_bag(*targs, combiner=combiner, use_pallas=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(jnn_bag(*jargs, combiner=combiner)),
                                   rtol=1e-5, atol=1e-5)
    assert torch.equal(nn_bag.one_hot_lookup(targs[0], targs[1])[2], torch.zeros(12))


def _collections():
    jtables = [jcol.TableConfig("t", vocab=50, dim=4, ids_per_step=12, cache_ratio=0.5)]
    jc = jcol.EmbeddingCollection.create(jtables, cache_ratio=0.5)
    jstate = jc.init(jax.random.PRNGKey(0))
    tc = col.EmbeddingCollection.create([col.TableConfig("t", vocab=50, dim=4, ids_per_step=12)],
                                        cache_ratio=0.5)
    tstate = convert.collection_state_from_numpy(jax_to_numpy(jstate), device="cpu")
    return (jc, jstate), (tc, tstate)


def test_pool_matches_reference_forward_and_grads():
    """``test_pipeline.py``'s fused-pool case on a converted collection: 1-D
    bag features plan to the reference's addresses, and both routes of
    ``pool`` match the reference's fused route, forward and gradient."""
    (jc, jstate), (tc, tstate) = _collections()
    flat = np.array([1, 2, 3, -1, 4, 5, 6, 7, -1, -1, 8, 9], np.int32)
    seg = np.array([0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2], np.int32)
    jfb = jcol.FeatureBatch.from_bags({"t": (jnp.asarray(flat), jnp.asarray(seg))},
                                      num_segments=3)
    tfb = col.FeatureBatch.from_bags({"t": (torch.from_numpy(flat), torch.from_numpy(seg))},
                                     num_segments=3)
    assert tfb.num_segments == 3 and tfb.segments["t"].dtype == torch.int32
    jstate, jaddr = jc.prepare(jstate, jfb)
    tstate, taddr = tc.prepare(tstate, tfb)
    assert np.array_equal(taddr["t"].numpy(), np.asarray(jaddr["t"]))
    assert_tree_equal(jax_to_numpy(jstate), convert.to_numpy(tstate))
    jw, tw = jc.weights(jstate), tc.weights(tstate)
    for combiner in ("sum", "mean"):
        def jloss(w, combiner=combiner):
            return jnp.sum(jc.pool({}, jfb, combiner, weights=w, addresses=jaddr,
                                   use_pallas=True)["t"] ** 2)

        want = jc.pool({}, jfb, combiner, weights=jw, addresses=jaddr, use_pallas=True)["t"]
        want_g = jax.grad(jloss)(jw)[col.SHARED_ARENA]
        for use_pallas in (True, False):
            w = {k: x.detach().requires_grad_() for k, x in tw.items()}
            rows = {} if use_pallas else tc.gather(w, taddr, tfb)
            got = tc.pool(rows, tfb, combiner, weights=w, addresses=taddr,
                          use_pallas=use_pallas)["t"]
            (got_g,) = torch.autograd.grad(torch.sum(got ** 2), [w[col.SHARED_ARENA]])
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6)
            np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-5)
    with pytest.raises(ValueError, match="weights= and addresses="):
        tc.pool({}, tfb, use_pallas=True)


# ----- the kernel's many-feature route: its search, its plain version, pool ---

def _lower_bound_warp(seg, lo, hi, key):
    """``csrc/embedding_bag.cu``'s ``lower_bound_warp`` in numpy: 32 lanes
    probe evenly spaced positions, a ballot keeps the sub-range holding the
    first index of [lo, hi) whose segment id is >= key (hi if none)."""
    lanes = np.arange(32)
    while hi - lo > 32:
        step = (hi - lo + 31) >> 5
        p = lo + (lanes + 1) * step - 1
        ge = (p >= hi) | (seg[np.minimum(p, len(seg) - 1)] >= key)
        j = int(np.argmax(ge)) if ge.any() else 32
        next_hi = min(lo + (j + 1) * step - 1, hi) if j < 32 else hi
        lo, hi = lo + j * step, next_hi
    p = lo + lanes
    ge = (p >= hi) | (seg[np.minimum(p, len(seg) - 1)] >= key)
    return lo + int(np.argmax(ge)) if ge.any() else hi


def _lower_bound_near(seg, lo, hi, key):
    p = lo + np.arange(32)
    ge = (p >= hi) | (seg[np.minimum(p, len(seg) - 1)] >= key)
    return lo + int(np.argmax(ge)) if ge.any() else _lower_bound_warp(seg, lo + 32, hi, key)


def _features(rng, s, spec):
    """Concatenated segment ids of features given as (lanes, low, high):
    segment ids drawn in [low, high) and sorted; lanes 0 is an empty
    feature, low < 0 and high > s give lanes that belong to no bag."""
    segs = [np.sort(rng.integers(lo, hi, n)).astype(np.int32) for n, lo, hi in spec]
    offsets = np.concatenate([[0], np.cumsum([len(x) for x in segs])]).astype(np.int64)
    return segs, offsets


@pytest.mark.parametrize("s,spec", [
    (9, [(30, -2, 11), (0, 0, 9), (12, 0, 3), (5, 9, 12)]),  # -1 and S lanes, an empty feature
    (50, [(40, 0, 50), (7, -1, 1)]),  # many empty bags; a feature of -1 and bag-0 lanes only
    (4, [(3000, -1, 5), (70, 1, 2)]),  # 3 search rounds; bags longer than 32 lanes
    (4096, [(16384, 0, 4096), (16384, -1, 4097), (1, 4095, 4096)]),  # the DLRM's bag shape
])
def test_kernel_bag_search_matches_bag_starts(s, spec):
    """The kernel finds bag s of feature f as lanes [lower_bound(s),
    lower_bound(s + 1)) of the feature's own lane range; the emulated
    32-way search equals ``bag_starts`` on each feature's segment ids."""
    rng = np.random.default_rng(s + len(spec))
    segs, offsets = _features(rng, s, spec)
    flat = np.concatenate(segs)
    for f, seg in enumerate(segs):
        lo, hi = int(offsets[f]), int(offsets[f + 1])
        want = kernel.bag_starts(torch.from_numpy(seg), s).numpy() + lo
        starts = [_lower_bound_warp(flat, lo, hi, b) for b in range(s)]
        ends = [_lower_bound_near(flat, st, hi, b + 1) for b, st in enumerate(starts)]
        assert starts == want[:-1].tolist(), f
        assert ends == want[1:].tolist(), f


def _multi_inputs(rng, v, d, s, spec, dtype):
    segs, offsets = _features(rng, s, spec)
    ids = [rng.integers(-1, v + 2, len(x)).astype(np.int32) for x in segs]  # some ids >= V
    table = torch.from_numpy(rng.normal(size=(v, d)).astype(np.float32)).to(dtype)
    return (table, torch.from_numpy(np.concatenate(ids)), torch.from_numpy(np.concatenate(segs)),
            offsets.tolist())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("max_bag", [0, 2])
def test_multi_feature_bag_matches_per_feature(dtype, combiner, max_bag):
    """The many-feature op over features of unequal lane counts (with -1
    and S lanes and an empty feature) is bitwise the single-feature op per
    feature, forward; its one backward is within 1e-5 of the per-feature
    backward's sum (the index_add_ order differs)."""
    rng = np.random.default_rng(3)
    s = 11
    table, ids, seg, offsets = _multi_inputs(
        rng, 40, 12, s, [(60, -1, 12), (0, 0, 1), (25, 0, 11), (9, 5, 6)], dtype)
    plain = kernel.embedding_bag_multi_plain(table, ids, seg, offsets, s, combiner, max_bag)
    assert plain.shape == (4, s, 12) and plain.dtype == dtype
    assert torch.equal(kernel.embedding_bag_multi(table, ids, seg, offsets, s, combiner, max_bag),
                       plain)
    g = torch.from_numpy(rng.normal(size=(4, s, 12)).astype(np.float32)).to(dtype)
    w = table.clone().requires_grad_()
    out = ops.embedding_bag_multi(w, ids, seg, offsets, s, combiner, max_bag)
    (got_g,) = torch.autograd.grad(torch.sum(out * g), [w])
    w1 = table.clone().requires_grad_()
    per = [ops.embedding_bag(w1, ids[lo:hi], seg[lo:hi], s, combiner, max_bag)
           for lo, hi in zip(offsets[:-1], offsets[1:])]
    for f, x in enumerate(per):
        assert torch.equal(out[f].detach(), x.detach()), f
    (want_g,) = torch.autograd.grad(sum(torch.sum(x * g[f]) for f, x in enumerate(per)), [w1])
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got_g.float(), want_g.float(), rtol=tol, atol=tol)


def test_pool_many_features_matches_reference_and_per_feature(monkeypatch):
    """``pool(use_pallas=True)`` over three bag features of unequal lane
    counts in the shared arena makes one many-feature call, equals the
    per-feature route bitwise and the reference's fused ``pool`` within
    rtol 1e-6 (forward) and 1e-5 (gradients)."""
    tables = [("a", 60, 30), ("b", 40, 20), ("c", 30, 14)]
    jc = jcol.EmbeddingCollection.create(
        [jcol.TableConfig(n, vocab=v, dim=4, ids_per_step=k, cache_ratio=0.5)
         for n, v, k in tables], cache_ratio=0.5)
    jstate = jc.init(jax.random.PRNGKey(1))
    tc = col.EmbeddingCollection.create(
        [col.TableConfig(n, vocab=v, dim=4, ids_per_step=k) for n, v, k in tables],
        cache_ratio=0.5)
    tstate = convert.collection_state_from_numpy(jax_to_numpy(jstate), device="cpu")
    rng = np.random.default_rng(4)
    s = 5
    bags = {}
    for (n, v, k), lanes in zip(tables, (13, 7, 10)):
        ids = rng.integers(-1, v, lanes).astype(np.int32)
        bags[n] = (ids, np.sort(rng.integers(0, s, lanes)).astype(np.int32))
    jfb = jcol.FeatureBatch.from_bags({n: (jnp.asarray(i), jnp.asarray(g))
                                       for n, (i, g) in bags.items()}, num_segments=s)
    tfb = col.FeatureBatch.from_bags({n: (torch.from_numpy(i), torch.from_numpy(g))
                                      for n, (i, g) in bags.items()}, num_segments=s)
    jstate, jaddr = jc.prepare(jstate, jfb)
    tstate, taddr = tc.prepare(tstate, tfb)
    for n in bags:
        assert np.array_equal(taddr[n].numpy(), np.asarray(jaddr[n]))
    jw, tw = jc.weights(jstate), tc.weights(tstate)
    calls = []
    multi = ops.embedding_bag_multi
    monkeypatch.setattr(ops, "embedding_bag_multi",
                        lambda *a, **k: calls.append(len(a[3]) - 1) or multi(*a, **k))
    for combiner in ("sum", "mean"):
        def jloss(w, combiner=combiner):
            out = jc.pool({}, jfb, combiner, weights=w, addresses=jaddr, use_pallas=True)
            return sum(jnp.sum(out[n] ** 2) for n in bags)

        want = jc.pool({}, jfb, combiner, weights=jw, addresses=jaddr, use_pallas=True)
        want_g = jax.grad(jloss)(jw)[col.SHARED_ARENA]
        w = {k: x.detach().requires_grad_() for k, x in tw.items()}
        calls.clear()
        got = tc.pool({}, tfb, combiner, weights=w, addresses=taddr, use_pallas=True)
        assert calls == [3]  # one call per pool call for the slab's three features
        assert list(got) == list(tfb.segments)
        (got_g,) = torch.autograd.grad(sum(torch.sum(got[n] ** 2) for n in bags),
                                       [w[col.SHARED_ARENA]])
        for n in bags:
            np.testing.assert_allclose(got[n].detach().numpy(), np.asarray(want[n]), rtol=1e-6)
            single = ops.embedding_bag(tw[col.SHARED_ARENA], taddr[n].reshape(-1),
                                       tfb.segments[n], s, combiner)
            assert torch.equal(got[n].detach(), single.detach()), n
        np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-7)
