"""The port's DIN, DIEN and MIND against the JAX package at the reference's
smoke shapes (histories of 8, batch 8, cache ratio 0.3; DIEN with 12 GRU
units; MIND at dim 16), with ``use_pallas_plan=True``: their layers, the
models initialised in JAX and carried across by ``repro_torch.convert``,
served, trained, flushed and scored for retrieval on the same
``recsys_batch`` batches; the batch generator, Adagrad, the smoke runs and
both launchers' new archs.

The JAX side is jitted, as its launchers run it (fp32 tiers throughout, so
the compiled transmitter moves rows exactly).

Tolerances (fp32):
* layer outputs within rtol 1e-5 / atol 1e-6, their gradients within rtol
  1e-4 / atol 1e-6 (XLA and torch order a matmul's sums differently, and
  the GRU's recurrence carries that over T);
* logits, retrieval scores and losses within rtol 1e-5 (atol 1e-6 where
  a value may be near 0), dense parameters, arena rows and the flushed host
  table within rtol 1e-5 / atol 1e-6;
* plans, hits, slots and counters bitwise (they depend on ids only), the
  tracker's float leaves within ``torch_parity.TRACKER_RTOL``.
"""
import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_tree_equal, jax_to_numpy

from repro.configs import dien as jdien_config
from repro.configs import din as jdin_config
from repro.configs import mind as jmind_config
from repro.data import synth as jsynth
from repro.dist.partitioning import split_params
from repro.models import recsys_models as J
from repro.nn import layers as jlayers
from repro.nn import recsys as JR
from repro.optim import optimizers as jopt
from repro_torch import convert
from repro_torch.configs import dien as dien_config
from repro_torch.configs import din as din_config
from repro_torch.configs import mind as mind_config
from repro_torch.configs import shapes
from repro_torch.core.collection import SHARED_ARENA
from repro_torch.data import synth
from repro_torch.models import recsys_models as T
from repro_torch.nn import layers, recsys
from repro_torch.optim import optimizers

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL = 1e-4
JF32 = jlayers.Dtypes(param=jnp.float32, compute=jnp.float32)
TF32 = layers.Dtypes(param=torch.float32, compute=torch.float32)

ARCHS = {  # port config module, reference config module, reference classes, port model
    "din": (din_config, jdin_config, J.DINConfig, J.DINModel, T.DINModel),
    "dien": (dien_config, jdien_config, J.DIENConfig, J.DIENModel, T.DIENModel),
    "mind": (mind_config, jmind_config, J.MINDConfig, J.MINDModel, T.MINDModel),
}
COUNTERS = ("cache_misses", "cache_evictions", "uniq_overflows", "host_wire_bytes")


def _tt(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _jj(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _ref_kw(cfg):
    """The port config's fields as the reference config's keywords."""
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name not in ("dtypes", "policy")}


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference model and its initial state (immutable: shared by the tests)."""
    mod, _, jcfg_cls, jmodel_cls, _ = ARCHS[arch]
    cfg = dataclasses.replace(mod.SMOKE, use_pallas_plan=True)
    jmodel = jmodel_cls(jcfg_cls(**_ref_kw(cfg)))
    return jmodel, jmodel.init(jax.random.PRNGKey(0))


def _pair(arch):
    """(reference model, its state), (port model, the state converted)."""
    jmodel, jstate = _reference(arch)
    tmodel = ARCHS[arch][4](dataclasses.replace(ARCHS[arch][0].SMOKE, use_pallas_plan=True))
    tstate = convert.state_from_numpy(jax_to_numpy(jstate), device="cpu")
    return (jmodel, jstate), (tmodel, tstate)


def _batch(arch, step, seed=0):
    c = ARCHS[arch][0].SMOKE
    return synth.recsys_batch(c.n_items, c.n_users, c.seq_len, c.batch_size, seed, step,
                              n_cates=None if arch == "mind" else c.n_cates)


def _retrieval_batch(arch, step, n=40):
    """One user's history and ``n`` candidates (some of them -1 padding)."""
    c = ARCHS[arch][0].SMOKE
    b = _batch(arch, step, seed=3)
    rng = np.random.default_rng(step)
    out = {"hist_items": b["hist_items"][:1], "hist_len": b["hist_len"][:1],
           "user": b["user"][:1],
           "candidates": rng.integers(-1, c.n_items, n).astype(np.int32)}
    if arch != "mind":
        out["hist_cates"] = b["hist_cates"][:1]
        out["candidate_cates"] = rng.integers(-1, c.n_cates, n).astype(np.int32)
    return out


def _close(want, got, path, rtol=RTOL, atol=ATOL):
    if isinstance(want, dict):
        assert set(want) == set(got), path
        for k in want:
            _close(want[k], got[k], f"{path}/{k}", rtol, atol)
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=path)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.detach().numpy()


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _torch_leaves(tree):
    """Port params as autograd leaves, with the same dict structure."""
    if isinstance(tree, dict):
        return {k: _torch_leaves(v) for k, v in tree.items()}
    return _torch_tree(tree).requires_grad_()


def _grads(tree):
    if isinstance(tree, dict):
        return {k: _grads(v) for k, v in tree.items()}
    return tree.grad.numpy()


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _layer_case(seed, b=6, t=8, d=10):
    rng = np.random.default_rng(seed)
    hist = rng.normal(size=(b, t, d)).astype(np.float32)
    lens = rng.integers(1, t + 1, b)
    mask = np.arange(t)[None, :] < lens[:, None]
    return rng, hist, mask


def test_din_attention_matches_reference():
    """Forward and the gradients of a random projection of the output with
    respect to the MLP, the history and the target."""
    rng, hist, mask = _layer_case(0)
    target = rng.normal(size=(hist.shape[0], hist.shape[2])).astype(np.float32)
    cot = rng.normal(size=target.shape).astype(np.float32)
    jp, _ = split_params(JR.din_attention_init(jax.random.PRNGKey(1), hist.shape[2], (12, 6),
                                               JF32))
    jp = jax.tree_util.tree_map(np.asarray, jp)

    def jloss(p, h, tg):
        return jnp.sum(JR.din_attention(p, h, tg, jnp.asarray(mask), JF32) * cot)

    want = np.asarray(JR.din_attention(jp, hist, target, jnp.asarray(mask), JF32))
    jg = jax.grad(jloss, argnums=(0, 1, 2))(jp, jnp.asarray(hist), jnp.asarray(target))
    tp, th, ttg = _torch_leaves(jp), _torch_leaves(hist), _torch_leaves(target)
    got = recsys.din_attention(tp, th, ttg, torch.from_numpy(mask), TF32)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)
    (got * torch.from_numpy(cot)).sum().backward()
    _close(jax_to_numpy(jg[0]), _grads(tp), "attn", GRAD_RTOL, ATOL)
    _close(np.asarray(jg[1]), th.grad.numpy(), "hist", GRAD_RTOL, ATOL)
    _close(np.asarray(jg[2]), ttg.grad.numpy(), "target", GRAD_RTOL, ATOL)
    # the attention weights vanish on masked positions: their rows get no gradient
    assert not th.grad.numpy()[~mask].any()


@pytest.mark.parametrize("kind", ["gru", "augru"])
def test_gru_matches_reference(kind):
    """GRU (and AUGRU with softmax attention over the valid positions)
    forward, and the gradients of a random projection of every hidden state
    with respect to the weights, the inputs and the attention."""
    rng, xs, mask = _layer_case(1, d=7)
    d_h = 5
    cot = rng.normal(size=xs.shape[:2] + (d_h,)).astype(np.float32)
    logits = rng.normal(size=mask.shape).astype(np.float32)
    att = np.where(mask, np.exp(logits), 0).astype(np.float32)
    att = (att / att.sum(1, keepdims=True)).astype(np.float32)
    jp, _ = split_params(JR.gru_init(jax.random.PRNGKey(2), xs.shape[2], d_h, JF32))
    jp = jax.tree_util.tree_map(np.asarray, jp)
    jp["b"] = rng.normal(size=jp["b"].shape).astype(np.float32)  # a live bias
    a_j = jnp.asarray(att) if kind == "augru" else None

    def jloss(p, x, a):
        return jnp.sum(JR.gru(p, x, JF32, att=a) * cot)

    want = np.asarray(JR.gru(jp, jnp.asarray(xs), JF32, att=a_j))
    jg = jax.grad(jloss, argnums=(0, 1, 2) if kind == "augru" else (0, 1))(
        jp, jnp.asarray(xs), a_j)
    tp, tx = _torch_leaves(jp), _torch_leaves(xs)
    ta = _torch_leaves(att) if kind == "augru" else None
    got = (recsys.augru(tp, tx, ta, TF32) if kind == "augru" else recsys.gru(tp, tx, TF32))
    assert got.shape == xs.shape[:2] + (d_h,)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)
    (got * torch.from_numpy(cot)).sum().backward()
    _close(jax_to_numpy(jg[0]), _grads(tp), "gru", GRAD_RTOL, ATOL)
    _close(np.asarray(jg[1]), tx.grad.numpy(), "xs", GRAD_RTOL, ATOL)
    if kind == "augru":
        _close(np.asarray(jg[2]), ta.grad.numpy(), "att", GRAD_RTOL, ATOL)


def test_capsule_routing_matches_reference():
    """Interest capsules forward, and the gradients with respect to the
    behaviours and the bilinear map (the routing logits take none)."""
    rng, hist, mask = _layer_case(2, d=8)
    s = (rng.normal(size=(8, 8)) / np.sqrt(8)).astype(np.float32)
    cot = rng.normal(size=(hist.shape[0], 3, 8)).astype(np.float32)

    def jloss(h, sm):
        return jnp.sum(JR.capsule_routing(h, jnp.asarray(mask), sm, 3, 3) * cot)

    want = np.asarray(JR.capsule_routing(jnp.asarray(hist), jnp.asarray(mask),
                                         jnp.asarray(s), 3, 3))
    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(hist), jnp.asarray(s))
    th, ts = _torch_leaves(hist), _torch_leaves(s)
    got = recsys.capsule_routing(th, torch.from_numpy(mask), ts, 3, 3)
    assert got.shape == (hist.shape[0], 3, 8)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)
    (got * torch.from_numpy(cot)).sum().backward()
    _close(np.asarray(jg[0]), th.grad.numpy(), "hist", GRAD_RTOL, ATOL)
    _close(np.asarray(jg[1]), ts.grad.numpy(), "s_matrix", GRAD_RTOL, ATOL)


def test_mlp_act_defaults_to_relu():
    gen = torch.Generator().manual_seed(0)
    p = layers.mlp_init(gen, (4, 6, 3), TF32, torch.device("cpu"))
    x = torch.randn((5, 4), generator=gen)
    h = x @ p["l0"]["w"] + p["l0"]["b"]
    assert torch.equal(layers.mlp(p, x, TF32),
                       torch.relu(h) @ p["l1"]["w"] + p["l1"]["b"])
    assert torch.equal(layers.mlp(p, x, TF32, act=torch.sigmoid, final_act=True),
                       torch.sigmoid(torch.sigmoid(h) @ p["l1"]["w"] + p["l1"]["b"]))


# ---------------------------------------------------------------------------
# models: serve, train, flush, retrieval
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_converted_state_round_trips(arch):
    (_, jstate), (_, tstate) = _pair(arch)
    want = jax_to_numpy(jstate)
    assert_tree_equal(want, convert.to_numpy(tstate), skip=("opt",))
    keys = {"din": {"attn", "mlp"}, "dien": {"gru1", "gru2", "attn_proj", "mlp"},
            "mind": {"s_matrix"}}[arch]
    assert set(want["params"]) == keys


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_serve_step_matches_reference(arch):
    """Four read-only batches: logits within rtol 1e-5 / atol 1e-6, the
    counters and the whole cache state bitwise; then the cache invariant
    (cached rows give the logits of the host table's rows)."""
    (jmodel, jstate), (tmodel, tstate) = _pair(arch)
    jserve = jax.jit(jmodel.serve_step)
    for step in range(4):
        b = _batch(arch, step)
        jlogits, jemb = jserve(jstate, _jj(b))
        tlogits, temb = tmodel.serve_step(tstate, _tt(b))
        assert tlogits.shape == (8,)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=RTOL, atol=ATOL)
        jstate, tstate = dict(jstate, emb=jemb), dict(tstate, emb=temb)
        jm = jmodel.collection.metrics(jemb, writeback=False)
        tm = tmodel.collection.metrics(temb, writeback=False)
        for key in COUNTERS:
            assert float(tm[key]) == float(jm[key]), key
    assert int(tm["cache_misses"]) > 0
    assert_tree_equal(jax_to_numpy(jstate["emb"]), convert.to_numpy(tstate["emb"]))
    b = _tt(_batch(arch, 9))
    logits, emb = tmodel.serve_step(tstate, b)
    rows = tmodel.collection.dense_reference(emb, tmodel.features(b))
    assert torch.equal(logits, tmodel.fwd(tstate["params"], rows, b))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_step_and_flush_match_reference(arch):
    """Four train steps against the jitted reference: losses within rtol
    1e-5, counters bitwise; then the dense parameters and arena rows within
    rtol 1e-5 / atol 1e-6, the cache's index state bitwise, and after
    ``flush`` the host table within rtol 1e-5 / atol 1e-6."""
    (jmodel, jstate), (tmodel, tstate) = _pair(arch)
    jstep = jax.jit(jmodel.train_step)
    for step in range(4):
        b = _batch(arch, step)
        jstate, jm = jstep(jstate, _jj(b))
        tstate, tm = tmodel.train_step(tstate, _tt(b))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=RTOL, atol=0)
        for key in ("cache_misses", "cache_evictions", "uniq_overflows"):
            assert int(tm[key]) == int(jm[key]), key
        assert float(tm["hit_rate"]) == float(jm["hit_rate"])
    assert int(tm["cache_evictions"]) > 0
    want, got = jax_to_numpy(jstate), convert.to_numpy(tstate)
    _close(want["params"], got["params"], "params")
    assert int(got["step"]) == int(want["step"]) == 4
    jslab = want["emb"]["slabs"][SHARED_ARENA]
    tslab = got["emb"]["slabs"][SHARED_ARENA]
    assert_tree_equal(jslab["cache"], tslab["cache"], "cache", skip=("cached_rows",))
    assert_tree_equal(jslab["idx_map"], tslab["idx_map"], "idx_map")
    _close(jslab["cache"]["cached_rows"], tslab["cache"]["cached_rows"], "cached_rows")
    jfull = jax_to_numpy(jmodel.flush(jstate)["emb"].slabs[SHARED_ARENA].full.data)
    tflushed = tmodel.flush(tstate)["emb"].slabs[SHARED_ARENA]
    _close(jfull, convert.to_numpy(tflushed.full.data), "flushed host table")
    resident = torch.nonzero(tflushed.cache.slot_to_row >= 0)[:, 0]
    assert torch.equal(tflushed.cache.cached_rows["weight"][resident],
                       tflushed.full.data["weight"][tflushed.cache.slot_to_row[resident].long()])


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_retrieval_score_matches_reference(arch):
    """One user's history against 40 candidates (some -1): the user's rows
    through the cache, the candidates' from the host tier; scores within
    rtol 1e-5 / atol 1e-6 and the cache state bitwise, over three users."""
    (jmodel, jstate), (tmodel, tstate) = _pair(arch)
    jscore = jax.jit(jmodel.retrieval_score)
    for trial in range(3):
        batch = _retrieval_batch(arch, trial)
        want, jemb = jscore(jstate, _jj(batch))
        got, temb = tmodel.retrieval_score(tstate, _tt(batch))
        jstate, tstate = dict(jstate, emb=jemb), dict(tstate, emb=temb)
        assert got.shape == (40,) and bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert_tree_equal(jax_to_numpy(jemb)["slabs"][SHARED_ARENA]["cache"],
                      convert.to_numpy(temb)["slabs"][SHARED_ARENA]["cache"], "cache")
    for n_cand in (0, 40):
        specs = tmodel.input_specs(8, n_candidates=n_cand)
        want = jmodel.input_specs(8, n_candidates=n_cand)
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in specs.items()} == {
            k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_configs_match_reference(arch):
    """``CONFIG`` is the reference's, field for field, and its shared arena
    holds 4 194 304 slots (the unique bound); ``SMOKE`` is the reference's
    smoke shape."""
    mod, jmod, jcfg_cls, _, tmodel_cls = ARCHS[arch]
    assert _ref_kw(mod.CONFIG) == _ref_kw(jmod.CONFIG)
    spec = tmodel_cls(mod.CONFIG).collection.cached_slabs[SHARED_ARENA]
    assert spec.capacity == spec.unique_size() == 1 << 22
    assert spec.vocab == {"din": 12_000_256, "dien": 12_000_256, "mind": 5_000_000}[arch]
    smoke = {"din": dict(n_items=512, n_cates=64, n_users=32, seq_len=8, batch_size=8,
                         cache_ratio=0.3),
             "dien": dict(n_items=512, n_cates=64, n_users=32, seq_len=8, batch_size=8,
                          cache_ratio=0.3, gru_dim=12),
             "mind": dict(n_items=512, n_users=32, embed_dim=16, seq_len=8, batch_size=8,
                          cache_ratio=0.3)}[arch]
    assert _ref_kw(mod.SMOKE) == _ref_kw(jcfg_cls(**smoke))
    assert shapes.N_CANDIDATES == 1_000_000


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_smoke_run_matches_reference_shapes(arch):
    """``test_models_smoke.py``'s recsys run in the port: ``SMOKE`` from
    seed 0, one train step on ``recsys_batch(seed 0, step 0)`` and a
    retrieval of the reference smoke's candidates: finite, with the
    reference smoke's shapes."""
    mod, jmod, *_, tmodel_cls = ARCHS[arch]
    want = jmod.smoke()
    model = tmodel_cls(mod.SMOKE)
    state = model.init(0, device="cpu")
    b = _tt(_batch(arch, 0))
    state, metrics = model.train_step(state, b)
    n = 64 if arch == "mind" else 32
    ret = {"hist_items": b["hist_items"][:1], "hist_len": b["hist_len"][:1],
           "user": b["user"][:1], "candidates": torch.arange(n, dtype=torch.int32)}
    if arch != "mind":
        ret["hist_cates"] = b["hist_cates"][:1]
        ret["candidate_cates"] = torch.arange(n, dtype=torch.int32) % mod.SMOKE.n_cates
    scores, _ = model.retrieval_score(state, ret)
    assert want["finite"] and tuple(scores.shape) == want["logits_shape"]
    assert bool(torch.isfinite(metrics["loss"])) and bool(torch.isfinite(scores).all())


# ---------------------------------------------------------------------------
# the batch generator, Adagrad, the launchers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_cates", [None, 64, 1_000_000])
def test_recsys_batch_matches_reference(n_cates):
    for seed, step, shape in ((0, 0, (512, 32, 8, 8)), (3, 7, (10_000_000, 1_000_256, 100, 64)),
                              (1, 2, (200_000, 20_000, 50, 16))):
        want = jsynth.recsys_batch(*shape, seed, step, n_cates=n_cates)
        got = synth.recsys_batch(*shape, seed, step, n_cates=n_cates)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_adagrad_matches_reference():
    """Five Adagrad steps on a nested tree (a schedule for lr, a zero
    gradient lane): parameters and accumulators bitwise the reference's."""
    rng = np.random.default_rng(0)
    params = {"a": {"w": rng.normal(size=(5, 7)).astype(np.float32)},
              "b": rng.normal(size=(3,)).astype(np.float32)}
    grads = [{"a": {"w": rng.normal(size=(5, 7)).astype(np.float32)},
              "b": np.array([0.0, *rng.normal(size=2)], np.float32)} for _ in range(5)]
    lr = lambda s: 0.1 / (1.0 + 0.5 * s)  # noqa: E731
    jo, to = jopt.adagrad(lr), optimizers.adagrad(lr)
    jp, js = params, jo.init(params)
    tp = _torch_tree(params)
    ts = to.init(tp)
    for step, g in enumerate(grads):
        jp, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp, step)
        tp, ts = to.update(_torch_tree(g), ts, tp, step)
    assert_tree_equal(jax_to_numpy(jp), _np_tree(tp))
    assert_tree_equal(jax_to_numpy(js), _np_tree(ts))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_launcher_matches_reference_launcher(arch, capsys, monkeypatch):
    """``launch/train.py --arch din|dien|mind --pipeline-depth 2`` on the
    CPU, from the reference launcher's initial state: the same hits, misses
    and host wire bytes a step, losses within rtol 1e-5."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train

    runs = []

    class Recorded(jtrain.PipelinedTrainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            runs.append(self)

    monkeypatch.setattr(jtrain, "PipelinedTrainer", Recorded)
    argv = ["--arch", arch, "--steps", "3", "--batch", "16", "--pipeline-depth", "2"]
    monkeypatch.setattr("sys.argv", ["train", *argv, "--use-pallas-plan"])
    jtrain.main()
    want_out = capsys.readouterr().out
    jmodel, _ = jtrain._recsys_runner(arch, 16, use_pallas_plan=True)[:2]
    init = jax_to_numpy(jmodel.init(jax.random.PRNGKey(0)))
    monkeypatch.setattr(ARCHS[arch][4], "init", lambda self, seed, counts=None, device=None:
                        convert.state_from_numpy(init, device=device))
    got = train.main(["--device", "cpu", *argv])
    got_out = capsys.readouterr().out
    assert f"arch={arch} steps=3" in got_out
    want = runs[0].history
    assert len(got.history) == len(want) == 3
    for g, w in zip(got.history, want):
        for key in ("cache_hits", "cache_misses", "host_wire_bytes"):
            assert g[key] == w[key], key
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=RTOL, atol=0)
    assert got.history[-1]["cache_misses"] > 0
    for pattern in (r"cache hit rate: .*", r"host<->device traffic: .*"):
        assert re.search(pattern, got_out).group(0) == re.search(pattern, want_out).group(0)


@pytest.mark.parametrize("arch", ["mind", "din"])
def test_serve_launcher_matches_reference_launcher(arch, capsys, monkeypatch):
    """``launch/serve.py --arch mind|din`` (MIND is the default, as in the
    reference): the same request, hit and miss counts and host wire bytes
    as the reference launcher on the same batches."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve

    argv = ["--requests", "32", "--batch", "16"] + (["--arch", arch] if arch != "mind" else [])
    got = serve.main(["--device", "cpu", *argv])
    got_line = capsys.readouterr().out.strip().splitlines()[-1]
    monkeypatch.setattr("sys.argv", ["serve", *argv])
    jserve.main()
    out = capsys.readouterr().out.strip().splitlines()
    assert got["requests"] == 32 and got["uniq_overflows"] == 0
    for key in ("requests", "cache_hits", "cache_misses", "host_wire_bytes"):
        assert got[key] == int(re.search(rf"'{key}': (\d+)", out[-2]).group(1)), key
    assert got["cache_misses"] > 0 and got_line == out[-1]


@pytest.mark.parametrize("arch", ["din", "mind"])
def test_serve_engine_pads_a_short_batch_like_the_reference(arch):
    """The reference's ``test_data_serve.py`` engine case on the recsys
    schema: five requests into an engine of batch 8 padded with the serve
    launcher's pad example, twice; the scores within rtol 1e-5 / atol 1e-6
    of the reference engine's, the request counts and the cache counters
    equal."""
    from repro.serve.engine import ServeEngine as JServeEngine
    from repro_torch.launch.serve import pad_example
    from repro_torch.serve.engine import ServeEngine

    (jmodel, jstate), (tmodel, tstate) = _pair(arch)
    pad = pad_example(tmodel.cfg)
    jeng = JServeEngine(jmodel.serve_step, jstate, batch_size=8, pad_example=pad)
    teng = ServeEngine(tmodel.serve_step, tstate, batch_size=8, pad_example=pad, device="cpu")
    for step in range(2):
        batch = {k: v[:5] for k, v in _batch(arch, step, seed=5).items()}
        want, got = jeng.score(batch), teng.score(batch)
        assert got.shape == (5,)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert teng.stats.summary()["requests"] == jeng.stats.summary()["requests"] == 10
    jm = jmodel.collection.metrics(jeng.state["emb"], writeback=False)
    tm = tmodel.collection.metrics(teng.state["emb"], writeback=False)
    for key in COUNTERS:
        assert float(tm[key]) == float(jm[key]), key
