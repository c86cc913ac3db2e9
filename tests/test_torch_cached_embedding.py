"""The port's single-table ``CachedEmbedding`` (``core/cached_embedding.py``)
and ``models.common.EmbTrainStep`` against ``repro.core.cached_embedding``:
the ``ce`` cases of the reference's ``tests/test_cache.py`` and
``tests/test_store.py`` as parity tests, from the reference's state carried
across through numpy (``convert.cached_embedding_state_from_numpy``).

Tolerances: index state, slots, counters, arena and host tier are compared
bitwise against the eager reference with one transmitter round (its
compiled multi-round ``fori_loop`` may move an int8 code by an ulp), the
tracker's floats within ``TRACKER_RTOL``; pooled rows within fp32 rtol
1e-6; SGD row updates bitwise, and row-wise Adagrad bitwise at dim 8 (its
row mean of g**2 is a reduction whose order XLA and torch choose
differently at wider rows: at dim 16 the accumulators within rtol 1e-6 and
the rows within 1e-7, two fp32 ulps at the table's |w| < 1); the train
step's losses within rtol 1e-5 of the jitted reference.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_tree_equal, jax_to_numpy

from repro.core import cached_embedding as jce
from repro.core.policies import Policy as JPolicy
from repro.models import common as jcommon
from repro.optim import optimizers as joptim
from repro_torch import convert
from repro_torch.core import cached_embedding as ce
from repro_torch.core.policies import Policy
from repro_torch.models import common
from repro_torch.optim import optimizers as optim

CODECS = ["fp32", "fp16", "int8"]
BASE = dict(vocab_sizes=(50, 30), dim=8, ids_per_step=12, cache_ratio=0.2, buffer_rows=64)


def zipf_counts(vocab, seed=0):
    z = np.random.default_rng(seed).zipf(1.5, size=100_000) % vocab
    return np.bincount(z, minlength=vocab)


def _cfgs(**kw):
    kw = dict(BASE, **kw)
    jkw = dict(kw, policy=JPolicy(kw["policy"].value)) if "policy" in kw else kw
    return jce.CachedEmbeddingConfig(**jkw), ce.CachedEmbeddingConfig(**kw)


def _pair(jcfg, counts=None, warm=True):
    """The reference's init and the port's state converted from it."""
    jst = jce.init_state(jax.random.PRNGKey(0), jcfg, counts=counts, warm=warm)
    return jst, convert.cached_embedding_state_from_numpy(jax_to_numpy(jst), device="cpu")


def _same(jst, st, what=""):
    assert_tree_equal(jax_to_numpy(jst), convert.to_numpy(st), what)


def _ids(rng, shape, pad=0.1):
    ids = rng.integers(0, 80, size=shape).astype(np.int32)
    ids[rng.random(shape) < pad] = -1
    return ids


# --------------------------------------------------------------------------
# config, init and accounting
# --------------------------------------------------------------------------


@pytest.mark.parametrize("adagrad", [False, True])
@pytest.mark.parametrize("host", CODECS)
def test_init_state_and_device_bytes_match_reference(host, adagrad):
    """The port's own init: the reference's layout (leaves, shapes, dtypes),
    ``idx_map``, ``offsets`` and warmed index state bitwise (the rows are
    the port's own draw); the derived sizes and ``device_bytes`` equal."""
    jcfg, cfg = _cfgs(host_precision=host, rowwise_adagrad=adagrad)
    assert (cfg.vocab, cfg.unique_size, cfg.capacity) == (jcfg.vocab, jcfg.unique_size,
                                                          jcfg.capacity)
    assert ce.device_bytes(cfg) == jce.device_bytes(jcfg)
    counts = zipf_counts(cfg.vocab)
    want = jax_to_numpy(jce.init_state(jax.random.PRNGKey(0), jcfg, counts=counts))
    got = convert.to_numpy(ce.init_state(cfg, 0, counts=counts, device="cpu"))

    def layout(tree):
        if isinstance(tree, dict):
            return {k: layout(v) for k, v in tree.items()}
        return (tree.shape, tree.dtype) if isinstance(tree, np.ndarray) else tree

    assert layout(got) == layout(want)
    assert_tree_equal(want, got, skip=("cached_rows", "data", "sideband"))
    if adagrad:
        assert not got["full"]["data"]["accum"].any()
    gen = torch.Generator().manual_seed(0)
    again = ce.init_state(cfg, gen, counts=counts, device="cpu")
    assert torch.equal(again.full.data["weight"], torch.from_numpy(got["full"]["data"]["weight"]))


# --------------------------------------------------------------------------
# prepare_ids: slots and every index / counter tensor
# --------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [0, 16])
@pytest.mark.parametrize("host", CODECS)
@pytest.mark.parametrize("pallas", [False, True])
def test_prepare_ids_matches_reference(pallas, host, chunk):
    """Six ``prepare_ids`` calls (Zipf counts, -1 padding, evictions with
    write-back): slots and the whole state bitwise after each."""
    jcfg, cfg = _cfgs(host_precision=host, use_pallas_plan=pallas, chunk_rows=chunk)
    jst, st = _pair(jcfg, counts=zipf_counts(80))
    rng = np.random.default_rng(7)
    for step in range(6):
        ids = _ids(rng, (12,))
        jst, jslots = jce.prepare_ids(jcfg, jst, jnp.asarray(ids))
        st, slots = ce.prepare_ids(cfg, st, torch.from_numpy(ids))
        assert np.array_equal(np.asarray(jslots), slots.numpy()), step
        _same(jst, st, f"step {step}")
    assert int(st.cache.evictions) > 0


def test_padding_gives_zero_rows_and_overflow_counts():
    """All-padding lanes: slot -1 and zero rows; more distinct ids than
    ``max_unique_per_step`` counts one overflow, as in the reference."""
    jcfg, cfg = _cfgs(vocab_sizes=(100,), ids_per_step=16, max_unique_per_step=4, cache_ratio=0.3)
    jst, st = _pair(jcfg)
    st, slots = ce.prepare_ids(cfg, st, torch.full((16,), -1, dtype=torch.int32))
    assert bool((slots == -1).all()) and not ce.gather_slots(st, slots).any()
    for ids in (np.arange(16, dtype=np.int32), np.zeros(16, np.int32)):
        jst, _ = jce.prepare_ids(jcfg, jst, jnp.asarray(ids))
        st, _ = ce.prepare_ids(cfg, st, torch.from_numpy(ids))
        assert int(st.cache.uniq_overflows) == int(jst.cache.uniq_overflows) == 1


@pytest.mark.parametrize("policy", list(Policy))
def test_policies_match_reference(policy):
    """Every eviction policy: slots and state bitwise over four calls."""
    jcfg, cfg = _cfgs(policy=policy)
    jst, st = _pair(jcfg)
    rng = np.random.default_rng(3)
    for _ in range(4):
        ids = _ids(rng, (12,), pad=0.0)
        jst, jslots = jce.prepare_ids(jcfg, jst, jnp.asarray(ids))
        st, slots = ce.prepare_ids(cfg, st, torch.from_numpy(ids))
        assert np.array_equal(np.asarray(jslots), slots.numpy())
    _same(jst, st)


def test_writeback_false_keeps_the_host_table():
    jcfg, cfg = _cfgs(writeback=False)
    jst, st = _pair(jcfg)
    before = st.full.data["weight"].clone()
    for ids in _ids(np.random.default_rng(1), (4, 12)):
        st, _ = ce.prepare_ids(cfg, st, torch.from_numpy(ids))
    assert torch.equal(before, st.full.data["weight"]) and int(st.cache.evictions) > 0


# --------------------------------------------------------------------------
# lookups
# --------------------------------------------------------------------------


@pytest.mark.parametrize("how", ["onehot", "sum", "mean"])
def test_embed_onehot_and_bag_match_reference(how):
    """``embed_onehot`` and ``embed_bag`` (sum, mean) over five batches
    within fp32 rtol 1e-6, slots bitwise; the one-hot rows equal the
    flushed table's ``dense_reference_lookup`` (the cache is exact)."""
    jcfg, cfg = _cfgs()
    jst, st = _pair(jcfg, counts=zipf_counts(80))
    rng = np.random.default_rng(11)
    for _ in range(5):
        if how == "onehot":
            ids = np.stack([rng.integers(0, 50, 6), rng.integers(0, 30, 6)], 1).astype(np.int32)
            jst, jslots, jout = jce.embed_onehot(jcfg, jst, jnp.asarray(ids))
            st, slots, out = ce.embed_onehot(cfg, st, torch.from_numpy(ids))
            ref = ce.dense_reference_lookup(ce.flush_state(cfg, st), torch.from_numpy(ids))
            assert torch.equal(out, ref)
        else:
            ids = _ids(rng, (12,), pad=0.2)
            seg = np.sort(rng.integers(0, 5, 12)).astype(np.int32)
            seg[-1] = 7  # a segment past num_segments is dropped
            jst, jslots, jout = jce.embed_bag(jcfg, jst, jnp.asarray(ids), jnp.asarray(seg), 5,
                                              combiner=how)
            st, slots, out = ce.embed_bag(cfg, st, torch.from_numpy(ids), torch.from_numpy(seg),
                                          5, combiner=how)
        assert np.array_equal(np.asarray(jslots), slots.numpy())
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-6, atol=0)


# --------------------------------------------------------------------------
# updates, flush, the oracle
# --------------------------------------------------------------------------


@pytest.mark.parametrize("adagrad,dim", [(False, 8), (False, 16), (True, 8), (True, 16)])
def test_apply_row_grads_matches_reference(adagrad, dim):
    """Three prepare + ``apply_row_grads`` rounds with random gradients and
    lr 0.1: the arena (and accumulators) bitwise, but for Adagrad at dim 16
    (see the module docstring)."""
    jcfg, cfg = _cfgs(dim=dim, rowwise_adagrad=adagrad)
    jst, st = _pair(jcfg)
    rng = np.random.default_rng(5)
    for _ in range(3):
        ids = _ids(rng, (12,))
        jst, _ = jce.prepare_ids(jcfg, jst, jnp.asarray(ids))
        st, _ = ce.prepare_ids(cfg, st, torch.from_numpy(ids))
        g = rng.normal(size=(cfg.capacity, dim)).astype(np.float32)
        jst = jce.apply_row_grads(jcfg, jst, jnp.asarray(g), 0.1)
        st = ce.apply_row_grads(cfg, st, torch.from_numpy(g), 0.1)
    want, got = jax_to_numpy(jst), convert.to_numpy(st)
    if adagrad and dim > 8:
        for k, atol in (("weight", 1e-7), ("accum", 0.0)):
            np.testing.assert_allclose(got["cache"]["cached_rows"][k],
                                       want["cache"]["cached_rows"][k], rtol=1e-6, atol=atol)
        assert_tree_equal(want, got, skip=("cached_rows", "data"))
    else:
        assert_tree_equal(want, got)
    if adagrad:
        assert float(st.cache.cached_rows["accum"].max()) > 0


@pytest.mark.parametrize("adagrad", [False, True])
@pytest.mark.parametrize("host", CODECS)
def test_flush_and_dense_reference_match_reference(host, adagrad):
    """Four batches with ones as the gradient (lr 0.01), then
    ``flush_state``: the host tier bitwise the reference's (payload,
    sideband, accumulators), ``dense_reference_lookup`` bitwise, and the
    resident reads of the flushed state within one quantization step of
    the oracle (exact for fp32)."""
    jcfg, cfg = _cfgs(host_precision=host, rowwise_adagrad=adagrad)
    jst, st = _pair(jcfg)
    rng = np.random.default_rng(0)
    for _ in range(4):
        ids = rng.integers(0, (50, 30), size=(6, 2)).astype(np.int32)
        jst, _, _ = jce.embed_onehot(jcfg, jst, jnp.asarray(ids))
        st, _, _ = ce.embed_onehot(cfg, st, torch.from_numpy(ids))
        ones = np.ones((cfg.capacity, cfg.dim), np.float32)
        jst = jce.apply_row_grads(jcfg, jst, jnp.asarray(ones), 0.01)
        st = ce.apply_row_grads(cfg, st, torch.from_numpy(ones), 0.01)
    jst, st = jce.flush_state(jcfg, jst), ce.flush_state(cfg, st)
    _same(jst, st)
    ref = ce.dense_reference_lookup(st, torch.from_numpy(ids))
    assert np.array_equal(np.asarray(jce.dense_reference_lookup(jst, jnp.asarray(ids))),
                          ref.numpy())
    _, _, emb = ce.embed_onehot(cfg, st, torch.from_numpy(ids))
    atol = {"fp32": 0.0, "fp16": 1e-3, "int8": 0.01}[host]
    torch.testing.assert_close(emb, ref, rtol=0, atol=atol)
    if adagrad:
        assert float(st.full.data["accum"].max()) > 0


# --------------------------------------------------------------------------
# EmbTrainStep
# --------------------------------------------------------------------------


def _mlp_params(rng, d_in, hidden):
    return {"w1": (rng.normal(size=(d_in, hidden)) * 0.2).astype(np.float32),
            "b1": np.zeros((hidden,), np.float32),
            "w2": (rng.normal(size=(hidden, 1)) * 0.2).astype(np.float32)}


@pytest.mark.parametrize("adagrad", [False, True])
def test_emb_train_step_matches_reference(adagrad):
    """Four ``EmbTrainStep`` steps (a two-field table, dim 8, a 16-wide
    MLP over the dense features and the rows, SGD): losses within rtol
    1e-5 of the jitted reference; ``hit_rate``, ``cache_misses`` and
    ``uniq_overflows`` equal."""
    b, f, n_dense = 6, 2, 3
    jcfg, cfg = _cfgs(rowwise_adagrad=adagrad)
    jst, st = _pair(jcfg, counts=zipf_counts(80))
    params = _mlp_params(np.random.default_rng(2), n_dense + f * cfg.dim, 16)

    def jfwd(p, rows, batch):
        x = jnp.concatenate([batch["dense"], rows.reshape(b, f * cfg.dim)], axis=-1)
        return (jax.nn.relu(x @ p["w1"] + p["b1"]) @ p["w2"])[:, 0], {"aux": jnp.sum(rows)}

    def fwd(p, rows, batch):
        x = torch.cat([batch["dense"], rows.reshape(b, f * cfg.dim)], dim=-1)
        return (torch.relu(x @ p["w1"] + p["b1"]) @ p["w2"])[:, 0], {"aux": torch.sum(rows)}

    offsets = np.array([0, 50], np.int32)
    jstep = jax.jit(jcommon.EmbTrainStep(
        emb_cfg=jcfg, optimizer=joptim.sgd(0.1), fwd=jfwd,
        collect_ids=lambda batch: (batch["sparse"] + offsets).reshape(-1)))
    step = common.EmbTrainStep(
        emb_cfg=cfg, optimizer=optim.sgd(0.1), fwd=fwd,
        collect_ids=lambda batch: (batch["sparse"] + torch.from_numpy(offsets)).reshape(-1))
    jstate = {"params": {k: jnp.asarray(v) for k, v in params.items()}, "opt": (), "emb": jst,
              "step": jnp.zeros((), jnp.int32)}
    state = {"params": {k: torch.from_numpy(v.copy()) for k, v in params.items()}, "opt": (),
             "emb": st, "step": torch.zeros((), dtype=torch.int32)}
    rng = np.random.default_rng(4)
    for _ in range(4):
        batch = {"dense": rng.normal(size=(b, n_dense)).astype(np.float32),
                 "sparse": np.stack([rng.integers(0, 50, b), rng.integers(0, 30, b)],
                                    1).astype(np.int32),
                 "label": rng.integers(0, 2, b).astype(np.float32)}
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert set(m) == set(jm) == {"loss", "auc", "hit_rate", "cache_misses",
                                     "uniq_overflows", "aux"}
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5, atol=0)
        for k in ("hit_rate", "cache_misses", "uniq_overflows"):
            assert float(m[k]) == float(jm[k]), k
    assert int(state["step"]) == 4 and int(state["emb"].cache.misses) > 0


def test_dataclass_fields_carry_over():
    """The port's config and state have the reference's fields (the dtype
    a torch dtype)."""
    names = lambda c: [f.name for f in dataclasses.fields(c)]
    assert names(ce.CachedEmbeddingConfig) == names(jce.CachedEmbeddingConfig)
    assert names(ce.CachedEmbeddingState) == names(jce.CachedEmbeddingState)


def test_init_state_has_no_silent_cpu_fallback():
    """``init_state`` defaults to the card: without one it raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ce.init_state(ce.CachedEmbeddingConfig(**BASE))
