"""The port's serving slice as a whole against the JAX package: a small DLRM
with ``use_pallas_plan=True`` is initialised in JAX, its state converted
through ``repro_torch.convert``, and the same five Zipf batches go through
both ``ServeEngine``s.

Tolerances: logits within rtol 1e-5 / atol 1e-6 (fp32 matmuls reduce in a
different order in torch and XLA); cache index state bitwise (tracker
floats within ``torch_parity.TRACKER_RTOL``); the summaries' hit rate and
host wire bytes exactly equal.
"""
import jax
import numpy as np
import pytest
import torch
from torch_parity import assert_tree_equal, jax_to_numpy

from repro.data import synth as jsynth
from repro.models.dlrm import DLRM as JDLRM
from repro.models.dlrm import DLRMConfig as JDLRMConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.data import synth
from repro_torch.models.dlrm import DLRM, DLRMConfig
from repro_torch.serve.engine import ServeEngine

VOCABS = (128, 64, 256, 40)
SHAPE = dict(vocab_sizes=VOCABS, n_dense=13, embed_dim=16, batch_size=16, cache_ratio=0.25,
             bottom_mlp=(32, 16), top_mlp=(32, 16), buffer_rows=24, use_pallas_plan=True)
PAD = {"dense": np.zeros((13,), np.float32), "sparse": np.zeros((len(VOCABS),), np.int32),
       "label": np.zeros((), np.float32)}


def _engines():
    jmodel = JDLRM(JDLRMConfig(**SHAPE))
    jstate = jmodel.init(jax.random.PRNGKey(0))
    tmodel = DLRM(DLRMConfig(**SHAPE))
    tstate = convert.state_from_numpy(jax_to_numpy(jstate), device="cpu")
    jeng = JServeEngine(jmodel.serve_step, jstate, batch_size=16, pad_example=PAD,
                        state_stats_fn=lambda s: jmodel.collection.metrics(s["emb"], writeback=False))
    teng = ServeEngine(tmodel.serve_step, tstate, batch_size=16, pad_example=PAD, device="cpu",
                       state_stats_fn=lambda s: tmodel.collection.metrics(s["emb"], writeback=False))
    return jeng, teng


def test_converted_state_round_trips():
    jmodel = JDLRM(JDLRMConfig(**SHAPE))
    want = jax_to_numpy(jmodel.init(jax.random.PRNGKey(1)))
    got = convert.to_numpy(convert.state_from_numpy(want, device="cpu"))
    assert_tree_equal(want, got, skip=("opt",))


def test_batches_are_bit_identical_to_reference_generator():
    spec_j = jsynth.ZipfSparseSpec(vocab_sizes=VOCABS, n_dense=13)
    spec_t = synth.ZipfSparseSpec(vocab_sizes=VOCABS, n_dense=13)
    for step in range(3):
        a, b = jsynth.sparse_batch(spec_j, 16, 7, step), synth.sparse_batch(spec_t, 16, 7, step)
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def test_serve_engine_matches_reference():
    jeng, teng = _engines()
    spec = synth.ZipfSparseSpec(vocab_sizes=VOCABS, n_dense=13)
    for step in range(5):
        batch = synth.sparse_batch(spec, 11 if step == 2 else 16, 0, step)  # one padded batch
        want, got = jeng.score(batch), teng.score(batch)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    jemb = jax_to_numpy(jeng.state["emb"])
    temb = convert.to_numpy(teng.state["emb"])
    assert_tree_equal(jemb, temb)  # index state, arena and host table
    js, ts = jeng.summary(), teng.summary()
    assert js["hit_rate"] == ts["hit_rate"]
    assert js["host_wire_bytes"] == ts["host_wire_bytes"] > 0
    assert js["cache_misses"] == ts["cache_misses"]
    assert ts["uniq_overflows"] == 0
    assert ts["requests"] == js["requests"] == 75


def test_port_logits_equal_uncached_table_rows():
    """The cache invariant on the port: logits from the cached rows equal
    the logits from rows read straight out of the host table."""
    _, teng = _engines()
    model = DLRM(DLRMConfig(**SHAPE))
    spec = synth.ZipfSparseSpec(vocab_sizes=VOCABS, n_dense=13)
    for step in range(3):
        batch = {k: torch.from_numpy(v) for k, v in synth.sparse_batch(spec, 16, 3, step).items()}
        logits, emb = model.serve_step(teng.state, batch)
        teng.state = dict(teng.state, emb=emb)
        rows = model.collection.dense_reference(emb, model.features(batch))
        assert torch.equal(logits, model.fwd(teng.state["params"], rows, batch))


def test_serve_launcher_matches_reference_launcher(capsys, monkeypatch):
    """``launch/serve.py --arch dlrm-criteo`` on the CPU: the port's launcher
    serves its requests through the bounded top-K route and prints the same
    hit and miss counts and host wire bytes as the reference launcher on
    the same batches (they depend on the ids and the cache policy, not on
    the weights)."""
    import re

    from repro.launch import serve as jserve
    from repro_torch.launch import serve

    argv = ["--arch", "dlrm-criteo", "--requests", "32", "--batch", "16"]
    got = serve.main(["--device", "cpu", *argv])
    got_line = capsys.readouterr().out.strip().splitlines()[-1]
    monkeypatch.setattr("sys.argv", ["serve", *argv])
    jserve.main()
    out = capsys.readouterr().out.strip().splitlines()
    assert got["requests"] == 32 and got["uniq_overflows"] == 0
    for key in ("requests", "cache_hits", "cache_misses", "host_wire_bytes"):
        want = int(re.search(rf"'{key}': (\d+)", out[-2]).group(1))
        assert got[key] == want, key
    assert got["cache_misses"] > 0 and got_line == out[-1]


def test_unported_paths_raise():
    """Nothing of the serving slice raises any more: the sharded budget
    mode (ROADMAP item 17) builds, and its read-only refresh (item 11)
    runs over every cached slab and leaves the scores as they were."""
    model = DLRM(DLRMConfig(**dict(SHAPE, model_shards=2, device_budget_bytes=1 << 20)))
    state = model.init(0, device="cpu")
    b = {k: torch.from_numpy(v) for k, v in synth.sparse_batch(
        synth.ZipfSparseSpec(vocab_sizes=VOCABS, n_dense=13), 16, 0, 0).items()}
    logits, emb = model.serve_step(state, b)
    emb, report = model.collection.refresh(emb, writeback=False)
    assert set(report.swaps) == set(model.collection.cached_slabs)
    assert torch.equal(model.serve_step(dict(state, emb=emb), b)[0], logits)


@pytest.mark.parametrize("arena", ["fp16", "int8"])
def test_serve_launcher_arena_precision_matches_reference_launcher(arena, capsys, monkeypatch):
    """``launch/serve.py --arena-precision`` tiers the served arena as the
    reference launcher's flag does: the same hit and miss counts and host
    wire bytes, and the engine's state holds an arena of that codec."""
    import re

    from repro.launch import serve as jserve
    from repro_torch.launch import serve
    from repro_torch.store.arena import ArenaStore

    engines = []
    real = serve.ServeEngine

    class Recorded(real):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            engines.append(self)

    monkeypatch.setattr(serve, "ServeEngine", Recorded)
    argv = ["--arch", "dlrm-criteo", "--requests", "32", "--batch", "16",
            "--arena-precision", arena]
    got = serve.main(["--device", "cpu", *argv])
    capsys.readouterr()
    monkeypatch.setattr("sys.argv", ["serve", *argv])
    jserve.main()
    out = capsys.readouterr().out.strip().splitlines()
    for key in ("requests", "cache_hits", "cache_misses", "host_wire_bytes"):
        assert got[key] == int(re.search(rf"'{key}': (\d+)", out[-2]).group(1)), key
    arena_store = engines[0].state["emb"].slabs["__shared__"].cache.cached_rows
    assert isinstance(arena_store, ArenaStore) and arena_store.codec == arena
