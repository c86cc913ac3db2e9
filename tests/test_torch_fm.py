"""The port's FM slice against the JAX package: the FM-interaction op on
``test_kernels.py``'s shapes, and a small FM (``configs/fm.smoke``'s shape:
six fields of 64 rows, embed dim 4, batch 16, cache ratio 0.3, with
``use_pallas_plan=True``) initialised in JAX, its state carried across by
``repro_torch.convert``, served and trained on the same Zipf batches.

The JAX side runs as its own tests run it: Pallas in interpret mode on the
CPU, the model eagerly for serving (one transmitter round) and jitted for
training, as its launcher runs it.

Tolerances:
* the FM op: rtol 1e-3, atol 1e-5 * (max|ref| + 1), ``test_kernels.py``'s
  sweep tolerance (fp32 reduction-order noise scales with the output);
* logits within rtol 1e-5 / atol 1e-6, losses within rtol 1e-5, and the
  flushed host table within rtol 1e-5 / atol 1e-6 (torch and XLA sum in
  different orders); cache index state and counters bitwise (they depend on
  ids only), the tracker's float leaves within ``torch_parity.TRACKER_RTOL``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_tree_equal, jax_to_numpy

from repro.kernels.fm_interaction import ops as jfm_ops
from repro.kernels.fm_interaction import ref as jfm_ref
from repro.models.recsys_models import FMConfig as JFMConfig
from repro.models.recsys_models import FMModel as JFMModel
from repro_torch import convert
from repro_torch.configs import fm as fm_config
from repro_torch.core.collection import SHARED_ARENA
from repro_torch.data import synth
from repro_torch.kernels.fm_interaction import kernel, ops, ref
from repro_torch.models.recsys_models import FMConfig, FMModel
from repro_torch.nn import recsys

VOCABS = (64,) * 6
SHAPE = dict(vocab_sizes=VOCABS, embed_dim=4, batch_size=16, cache_ratio=0.3,
             use_pallas_plan=True)
RTOL, ATOL = 1e-5, 1e-6


def _batch(step, batch=16, seed=0):
    return synth.sparse_batch(synth.ZipfSparseSpec(vocab_sizes=VOCABS), batch, seed, step)


def _tt(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _jj(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _pair(**kw):
    cfg = dict(SHAPE, **kw)
    jmodel, tmodel = JFMModel(JFMConfig(**cfg)), FMModel(FMConfig(**cfg))
    jstate = jmodel.init(jax.random.PRNGKey(0))
    tstate = convert.state_from_numpy(jax_to_numpy(jstate), device="cpu")
    return (jmodel, jstate), (tmodel, tstate)


@pytest.mark.parametrize("b,f,d", [(64, 39, 10), (1000, 26, 16), (128, 8, 128), (1, 4, 4)])
def test_fm_interaction_matches_reference(b, f, d):
    rng = np.random.default_rng(b + f)
    v_np = rng.normal(size=(b, f, d)).astype(np.float32)
    want = np.asarray(jfm_ops.fm_interaction(jnp.asarray(v_np)))  # Pallas, interpret mode
    want_ref = np.asarray(jfm_ref.fm_interaction_ref(jnp.asarray(v_np)))
    want_naive = np.asarray(jfm_ref.fm_interaction_naive(jnp.asarray(v_np)))
    tol = dict(rtol=1e-3, atol=1e-5 * (float(np.abs(want_ref).max()) + 1.0))
    v = torch.from_numpy(v_np)
    got = ops.fm_interaction(v)
    assert got.dtype == torch.float32 and got.shape == (b,)
    np.testing.assert_allclose(got.numpy(), want, **tol)
    np.testing.assert_allclose(kernel.fm_interaction_plain(v).numpy(), want_ref, **tol)
    np.testing.assert_allclose(ref.fm_interaction_ref(v).numpy(), want_ref, **tol)
    np.testing.assert_allclose(ref.fm_interaction_naive(v).numpy(), want_naive, **tol)
    # FM's own layout: a [..., :D] view of [B, F, D+1] rows, read without a copy
    wide = torch.cat([v, torch.ones((b, f, 1))], dim=-1)
    np.testing.assert_allclose(ops.fm_interaction(wide[..., :d]).numpy(), want, **tol)


def test_fm_interaction_bf16_and_the_layer():
    rng = np.random.default_rng(3)
    v = torch.from_numpy(rng.normal(size=(33, 7, 5)).astype(np.float32))
    out = ops.fm_interaction(v.to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    want = ref.fm_interaction_ref(v.to(torch.bfloat16).to(torch.float32))
    torch.testing.assert_close(out.to(torch.float32), want.to(torch.bfloat16).to(torch.float32))
    assert torch.equal(recsys.fm_interaction(v, use_pallas=True), ops.fm_interaction(v))
    torch.testing.assert_close(recsys.fm_interaction(v), ref.fm_interaction_ref(v))


def test_fm_kernel_refuses_autograd():
    """The FM kernel has no backward (the reference's cannot be linearised):
    the wrapper raises instead of returning a result with no graph."""
    v = torch.ones((2, 3, 4), requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.fm_interaction(v)
    with torch.no_grad():
        assert ops.fm_interaction(v).shape == (2,)
    with pytest.raises(ValueError):
        ops.fm_interaction(torch.ones((2, 3)))


def test_converted_fm_state_round_trips():
    (_, jstate), (_, tstate) = _pair()
    want = jax_to_numpy(jstate)
    assert_tree_equal(want, convert.to_numpy(tstate), skip=("opt",))
    assert set(want["params"]) == {"bias"}


def test_fm_serve_step_matches_reference():
    (jmodel, jstate), (tmodel, tstate) = _pair(use_pallas=True)
    for step in range(4):
        b = _batch(step)
        jlogits, jemb = jmodel.serve_step(jstate, _jj(b))
        tlogits, temb = tmodel.serve_step(tstate, _tt(b))
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=RTOL, atol=ATOL)
        jstate, tstate = dict(jstate, emb=jemb), dict(tstate, emb=temb)
        jm = jmodel.collection.metrics(jemb, writeback=False)
        tm = tmodel.collection.metrics(temb, writeback=False)
        for key in ("cache_misses", "cache_evictions", "uniq_overflows", "host_wire_bytes"):
            assert float(tm[key]) == float(jm[key]), key
    assert int(tm["cache_misses"]) > 0
    assert_tree_equal(jax_to_numpy(jstate["emb"]), convert.to_numpy(tstate["emb"]))
    # the cache invariant: cached rows give the logits of the host table's rows
    b = _tt(_batch(9))
    logits, emb = tmodel.serve_step(tstate, b)
    rows = tmodel.collection.dense_reference(emb, tmodel.features(b))
    assert torch.equal(logits, tmodel.fwd(tstate["params"], rows, b))


def test_fm_train_step_matches_reference():
    (jmodel, jstate), (tmodel, tstate) = _pair()
    jstep = jax.jit(jmodel.train_step)
    for step in range(3):
        b = _batch(step)
        jstate, jm = jstep(jstate, _jj(b))
        tstate, tm = tmodel.train_step(tstate, _tt(b))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=RTOL, atol=0)
        for key in ("cache_misses", "cache_evictions", "uniq_overflows"):
            assert int(tm[key]) == int(jm[key]), key
    want, got = jax_to_numpy(jstate), convert.to_numpy(tstate)
    np.testing.assert_allclose(got["params"]["bias"], want["params"]["bias"], rtol=RTOL,
                               atol=ATOL)
    jslab = want["emb"]["slabs"][SHARED_ARENA]
    tslab = got["emb"]["slabs"][SHARED_ARENA]
    assert_tree_equal(jslab["cache"], tslab["cache"], "cache", skip=("cached_rows",))
    np.testing.assert_allclose(tslab["cache"]["cached_rows"]["weight"],
                               jslab["cache"]["cached_rows"]["weight"], rtol=RTOL, atol=ATOL)
    jfull = jax_to_numpy(jmodel.flush(jstate)["emb"].slabs[SHARED_ARENA].full.data)
    tfull = convert.to_numpy(tmodel.flush(tstate)["emb"].slabs[SHARED_ARENA].full.data)
    np.testing.assert_allclose(tfull["weight"], jfull["weight"], rtol=RTOL, atol=ATOL)


def test_fm_train_step_through_the_kernel_raises():
    model = FMModel(FMConfig(**dict(SHAPE, use_pallas=True)))
    state = model.init(0, device="cpu")
    with pytest.raises(RuntimeError, match="no backward"):
        model.train_step(state, _tt(_batch(0)))


def test_fm_config_and_unported_surfaces():
    cfg = fm_config.CONFIG
    spec = FMModel(cfg).collection.cached_slabs[SHARED_ARENA]
    assert len(cfg.vocab_sizes) == 40 and spec.vocab == 33_764_352 and spec.dim == 11
    assert spec.unique_size() == spec.capacity == 1 << 21
    model = FMModel(FMConfig(**SHAPE))
    specs = model.input_specs(8)
    assert specs["sparse"].shape == (8, 6) and specs["label"].dtype == torch.float32
    specs = model.input_specs(1, n_candidates=32)  # the retrieval batch
    assert specs["sparse"].shape == (1, 5) and specs["candidates"].shape == (32,)


def test_fm_train_launcher_matches_reference_launcher(capsys, monkeypatch):
    """``launch/train.py --arch fm`` on the CPU, from the reference
    launcher's initial state: the same hits, misses and host wire bytes per
    step, losses within rtol 1e-5."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train

    runs = []

    class Recorded(jtrain.Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            runs.append(self)

    monkeypatch.setattr(jtrain, "Trainer", Recorded)
    argv = ["--arch", "fm", "--steps", "3", "--batch", "16"]
    monkeypatch.setattr("sys.argv", ["train", *argv, "--use-pallas-plan"])
    jtrain.main()
    capsys.readouterr()
    jcfg = JFMConfig(vocab_sizes=(100_000,) * 6, embed_dim=10, batch_size=16, cache_ratio=0.02,
                     use_pallas_plan=True)
    init = jax_to_numpy(JFMModel(jcfg).init(jax.random.PRNGKey(0)))
    monkeypatch.setattr(FMModel, "init", lambda self, seed, counts=None, device=None:
                        convert.state_from_numpy(init, device=device))
    got = train.main(["--device", "cpu", *argv])
    assert "arch=fm steps=3" in capsys.readouterr().out
    want = runs[0].history
    assert len(got.history) == len(want) == 3
    for g, w in zip(got.history, want):
        for key in ("cache_hits", "cache_misses", "host_wire_bytes"):
            assert g[key] == w[key], key
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=RTOL, atol=0)
    assert got.history[-1]["cache_misses"] > 0


@pytest.mark.parametrize("host", ["fp32", "int8"])
def test_retrieval_score_matches_reference(host):
    """One user's five context fields against 40 candidates of the last
    field (some of them -1 padding): the context rows through the cache,
    the candidates straight from the host tier (decoded for int8), scores
    within rtol 1e-5 / atol 1e-6 of the reference's, run eagerly as its
    own serving path runs."""
    (jmodel, jstate), (tmodel, tstate) = _pair(host_precision=host)
    rng = np.random.default_rng(4)
    for trial in range(3):
        cands = rng.integers(-1, 64, 40).astype(np.int32)
        batch = {"sparse": _batch(trial)["sparse"][:1, :5], "candidates": cands}
        want, jemb = jmodel.retrieval_score(jstate, _jj(batch))
        got, temb = tmodel.retrieval_score(tstate, _tt(batch))
        jstate, tstate = dict(jstate, emb=jemb), dict(tstate, emb=temb)
        assert got.shape == (40,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert_tree_equal(jax_to_numpy(jemb)["slabs"][SHARED_ARENA]["cache"],
                      convert.to_numpy(temb)["slabs"][SHARED_ARENA]["cache"], "cache")
    specs = tmodel.input_specs(8, n_candidates=40)
    assert {k: tuple(v.shape) for k, v in specs.items()} == {
        k: tuple(v.shape) for k, v in jmodel.input_specs(8, n_candidates=40).items()}
