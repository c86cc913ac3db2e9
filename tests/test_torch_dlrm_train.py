"""The port's training slice as a whole against the JAX package: a small
DLRM with ``use_pallas_plan=True`` is initialised in JAX, its state
converted through ``repro_torch.convert``, and the same Zipf batches go
through both ``train_step``s (the reference's jitted, as its launcher runs
it).

Tolerances (fp32):
* losses within rtol 1e-5, dense parameters and fp32 arena / head rows
  within rtol 1e-5 / atol 1e-6: torch and XLA reduce the matmuls and the
  embedding gradient (a scatter-add of duplicate ids) in different orders;
* cache index state and the tier counters bitwise (they depend on ids
  only), the tracker's float leaves within ``torch_parity.TRACKER_RTOL``;
* tiered tails: int8 / fp16 payloads within one code (|dq| <= 1: a row
  that differs from the reference by an ulp may round to the neighbouring
  code; these runs show 0 such lanes, and at most 1 % is allowed), the int8
  (scale, zp) sideband within rtol 1e-5 / atol 1e-7;
* after ``flush``, the host table within rtol 1e-5 / atol 1e-6.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_tree_equal, jax_to_numpy

from repro.models.dlrm import DLRM as JDLRM
from repro.models.dlrm import DLRMConfig as JDLRMConfig
from repro_torch import convert
from repro_torch.core import cache as tcache
from repro_torch.core import collection as col
from repro_torch.core.collection import SHARED_ARENA
from repro_torch.data import synth
from repro_torch.models.dlrm import DLRM, DLRMConfig
from repro_torch.store.arena import ArenaStore
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.trainer import Trainer, TrainerConfig

VOCABS = (128, 64, 256)
SHAPE = dict(vocab_sizes=VOCABS, n_dense=13, embed_dim=16, batch_size=16, cache_ratio=0.25,
             lr=0.1, bottom_mlp=(32, 16), top_mlp=(32, 16), buffer_rows=24,
             use_pallas_plan=True)
RTOL, ATOL = 1e-5, 1e-6


def _batch(step, batch=16, vocabs=VOCABS, seed=0):
    spec = synth.ZipfSparseSpec(vocab_sizes=vocabs, n_dense=13)
    return synth.sparse_batch(spec, batch, seed, step)


def _tt(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _close(want, got, path, rtol=RTOL, atol=ATOL):
    if isinstance(want, dict):
        for k in want:
            _close(want[k], got[k], f"{path}/{k}", rtol, atol)
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=path)


def _codes(payload):
    """int8 codes, or fp16 bit patterns (neighbouring values differ by 1)."""
    return (payload.view(np.int16) if payload.dtype == np.float16 else payload).astype(np.int64)


def _assert_arena_close(want, got, path):
    """fp32 dict or tiered ArenaStore, at the tolerances of the docstring."""
    if "codec" not in want:
        return _close(want, got, path)
    assert want["codec"] == got["codec"]
    _close(want["head"], got["head"], f"{path}/head")
    for k, wq in want["tail"].items():
        dq = np.abs(_codes(wq) - _codes(got["tail"][k]))
        n_diff = int((dq > 0).sum())
        assert dq.max(initial=0) <= 1 and n_diff <= 0.01 * dq.size, (path, k, n_diff)
    _close(want["sideband"], got["sideband"], f"{path}/sideband", atol=1e-7)


def _pair(precision, **kw):
    cfg = dict(SHAPE, arena_precision=precision, **kw)
    jmodel, tmodel = JDLRM(JDLRMConfig(**cfg)), DLRM(DLRMConfig(**cfg))
    jstate = jmodel.init(jax.random.PRNGKey(0))
    tstate = convert.state_from_numpy(jax_to_numpy(jstate), device="cpu")
    return (jmodel, jstate), (tmodel, tstate)


@pytest.mark.parametrize("precision", ["fp32", "fp16", "int8"])
def test_train_step_matches_reference(precision):
    (jmodel, jstate), (tmodel, tstate) = _pair(precision)
    jstep = jax.jit(jmodel.train_step)
    for step in range(5):
        b = _batch(step)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tmodel.train_step(tstate, _tt(b))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=RTOL, atol=0)
        for key in ("cache_misses", "cache_evictions", "uniq_overflows"):
            assert int(tm[key]) == int(jm[key]), key
        for key in ("slab_hits", "slab_tier_promotions", "slab_tier_demotions"):
            assert int(tm[key][SHARED_ARENA]) == int(jm[key][SHARED_ARENA]), key
    want, got = jax_to_numpy(jstate), convert.to_numpy(tstate)
    assert int(got["step"]) == int(want["step"]) == 5 and got["opt"] == want["opt"] == ()
    _close(want["params"], got["params"], "params")
    jslab = want["emb"]["slabs"][SHARED_ARENA]
    tslab = got["emb"]["slabs"][SHARED_ARENA]
    assert_tree_equal(jslab["cache"], tslab["cache"], "cache", skip=("cached_rows",))
    assert np.array_equal(jslab["idx_map"], tslab["idx_map"])
    _assert_arena_close(jslab["cache"]["cached_rows"], tslab["cache"]["cached_rows"], "arena")
    _close(jslab["full"]["data"], tslab["full"]["data"], "host table")  # writebacks so far
    want = jax_to_numpy(jmodel.flush(jstate)["emb"].slabs[SHARED_ARENA].full.data)
    tslab = tmodel.flush(tstate)["emb"].slabs[SHARED_ARENA]
    _close(want, convert.to_numpy(tslab.full.data), "flushed host table")
    # the flushed table holds exactly the arena's decoded resident rows
    rows = tslab.cache.slot_to_row
    resident = torch.nonzero(rows >= 0)[:, 0].to(torch.int32)
    assert torch.equal(tcache.lookup_slots(tslab.cache, resident),
                       tslab.full["weight"][rows[resident].long()])


def _port_losses(cache_ratio=0.25, precision="fp32", steps=15, batch=32, **kw):
    cfg = DLRMConfig(vocab_sizes=(512, 256, 128), embed_dim=16, batch_size=batch,
                     cache_ratio=cache_ratio, lr=0.5, bottom_mlp=(32, 16), top_mlp=(32,),
                     arena_precision=precision, use_pallas_plan=True, **kw)
    model = DLRM(cfg)
    state = model.init(0, device="cpu")
    losses = []
    for i in range(steps):
        state, m = model.train_step(state, _tt(_batch(i, batch, cfg.vocab_sizes)))
        losses.append(float(m["loss"]))
    return np.asarray(losses), state, model


def test_cache_ratio_does_not_change_training():
    """The software cache is exact data movement: fp32 loss curves agree
    across cache ratios (1.0 = effectively uncached)."""
    base, _, _ = _port_losses(cache_ratio=1.0)
    for ratio in (0.25, 0.5):
        losses, _, _ = _port_losses(cache_ratio=ratio)
        np.testing.assert_allclose(losses, base, rtol=RTOL, atol=ATOL)


def test_int8_arena_trains_to_loss_parity():
    ref, _, _ = _port_losses(steps=25, batch=16)
    got, state, model = _port_losses(precision="int8", steps=25, batch=16)
    assert np.mean(got[-5:]) < np.mean(got[:5])
    assert abs(np.mean(got[-5:]) - np.mean(ref[-5:])) < 0.05
    arena = state["emb"].slabs[SHARED_ARENA].cache.cached_rows
    assert isinstance(arena, ArenaStore) and arena.tail["weight"].dtype == torch.int8
    assert arena.device_bytes() < arena.fp32_equiv_bytes()
    assert model.collection.device_bytes()["arena_bytes_saved"] > 0


def _tiered(precision="int8", ratio=0.25):
    model = DLRM(DLRMConfig(**dict(SHAPE, arena_precision=precision, arena_head_ratio=ratio)))
    return model, model.init(0, device="cpu")


def test_checkpoint_round_trip_of_a_tiered_state(tmp_path):
    model, state = _tiered()
    for step in range(3):
        state, _ = model.train_step(state, _tt(_batch(step)))
    state = model.flush(state)
    ckpt.save(tmp_path, 3, state)
    _, template = _tiered()
    restored, step = ckpt.restore(tmp_path, template)
    assert step == 3 and ckpt.latest_step(tmp_path) == 3
    assert_tree_equal(convert.to_numpy(state), convert.to_numpy(restored))


def test_tiered_checkpoint_into_fp32_template_fails_loudly(tmp_path):
    _, state = _tiered()
    ckpt.save(tmp_path, 0, state)
    with pytest.raises(ValueError, match="no leaf"):
        ckpt.restore(tmp_path, _tiered("fp32")[1])
    with pytest.raises(ValueError, match="arena_precision"):
        ckpt.restore(tmp_path, _tiered("int8", ratio=0.5)[1])


def test_trainer_resumes_from_its_checkpoint(tmp_path):
    """4 steps, a checkpoint (after a flush), then a new trainer resumes at
    step 4: steps 4-5 give the losses of one uninterrupted 6-step run."""
    model = DLRM(DLRMConfig(**SHAPE))

    def trainer(steps, ckpt_dir=None):
        return Trainer(TrainerConfig(max_steps=steps, ckpt_dir=ckpt_dir, ckpt_every=4),
                       init_fn=lambda: model.init(0, device="cpu"), step_fn=model.train_step,
                       make_batch=_batch, flush_fn=model.flush, device="cpu")

    full = trainer(6)
    full.run()
    first = trainer(4, tmp_path)
    first.run()
    resumed = trainer(6, tmp_path)
    resumed.run()
    assert [h["step"] for h in resumed.history] == [4, 5]
    assert [h["loss"] for h in first.history + resumed.history] == \
        [h["loss"] for h in full.history]
    assert resumed.history[-1]["cache_misses"] == full.history[-1]["cache_misses"]


def test_trainer_writes_its_observability_artifacts(tmp_path):
    import json

    model = DLRM(DLRMConfig(**SHAPE))
    tr = Trainer(TrainerConfig(max_steps=3, obs_dir=str(tmp_path), history_limit=1),
                 init_fn=lambda: model.init(0, device="cpu"), step_fn=model.train_step,
                 make_batch=_batch, device="cpu")
    tr.run()
    assert [h["step"] for h in tr.history] == [2]
    recs = [json.loads(line) for line in open(tmp_path / "train.jsonl")]
    steps = [r for r in recs if r["kind"] == "step"]
    assert [r["step"] for r in steps] == [0, 1, 2]
    assert steps[-1]["cache_misses"] == tr.history[-1]["cache_misses"] > 0
    assert {"hist", "spans", "summary"} <= {r["kind"] for r in recs}
    trace = json.load(open(tr.trace_path))
    assert {"step", "host-transfer"} <= {e["name"] for e in trace["traceEvents"]}


def test_trainer_raises_on_unique_buffer_overflow():
    model = DLRM(DLRMConfig(**dict(SHAPE, max_unique_per_step=4)))
    tr = Trainer(TrainerConfig(max_steps=2), init_fn=lambda: model.init(0, device="cpu"),
                 step_fn=model.train_step, make_batch=_batch, device="cpu")
    with pytest.raises(RuntimeError, match="overflow"):
        tr.run()


def test_unported_trainer_options_raise():
    """No trainer option raises any more: ``pipeline_depth`` (ROADMAP item
    9) and ``refresh_interval`` (item 11) are accepted, and the model's
    refresh runs on a trained, tiered state."""
    assert TrainerConfig(max_steps=1, pipeline_depth=2).pipeline_depth == 2
    assert TrainerConfig(max_steps=1, refresh_interval=5).refresh_interval == 5
    model, state = _tiered()
    for step in range(3):
        state, _ = model.train_step(state, _tt(_batch(step)))
    state = model.refresh(state)
    assert set(state) == {"params", "opt", "emb", "step"}
    assert int(model.collection.metrics(state["emb"])["refresh_swaps"]) >= 0


def test_train_launcher_matches_reference_launcher(capsys, monkeypatch):
    """``launch/train.py --arch dlrm-criteo --arena-precision int8`` on the
    CPU, from the reference launcher's initial state: the same hits, misses
    and host wire bytes per step (they depend on the ids and the cache
    policy only), losses within rtol 1e-5."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train

    runs = []

    class Recorded(jtrain.Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            runs.append(self)

    monkeypatch.setattr(jtrain, "Trainer", Recorded)
    argv = ["--arch", "dlrm-criteo", "--steps", "3", "--batch", "16",
            "--arena-precision", "int8"]
    monkeypatch.setattr("sys.argv", ["train", *argv, "--use-pallas-plan"])
    jtrain.main()
    want_out = capsys.readouterr().out
    jcfg = JDLRMConfig(vocab_sizes=(100_000, 50_000, 20_000), embed_dim=32, batch_size=16,
                       cache_ratio=0.02, lr=0.3, bottom_mlp=(64, 32), top_mlp=(64,),
                       arena_precision="int8", use_pallas_plan=True)
    init = jax_to_numpy(JDLRM(jcfg).init(jax.random.PRNGKey(0)))
    monkeypatch.setattr(DLRM, "init", lambda self, seed, counts=None, device=None:
                        convert.state_from_numpy(init, device=device))
    got = train.main(["--device", "cpu", *argv])
    got_out = capsys.readouterr().out
    want = runs[0].history
    assert len(got.history) == len(want) == 3
    for g, w in zip(got.history, want):
        for key in ("cache_hits", "cache_misses", "host_wire_bytes"):
            assert g[key] == w[key], key
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=RTOL, atol=0)
    assert got.history[-1]["cache_misses"] > 0 and got.history[-1]["host_wire_bytes"] > 0
    for pattern in (r"cache hit rate: .*", r"host<->device traffic: .*", r"arena tier .*"):
        assert re.search(pattern, got_out).group(0) == re.search(pattern, want_out).group(0)


BUDGET = 24_000  # VOCABS at dim 16: f0 and f1 DEVICE, f2 CACHED


def _codes_close(want, got, path):
    """Encoded host payloads within one code (an ulp apart before the
    encode may round to the neighbouring code), at most 1 % of them."""
    dq = np.abs(_codes(want) - _codes(got))
    assert dq.max(initial=0) <= 1 and int((dq > 0).sum()) <= 0.01 * dq.size, path


@pytest.mark.parametrize("host", ["fp32", "int8"])
def test_budget_mode_train_step_matches_reference(host):
    """The device-budget DLRM (DEVICE and CACHED slabs, an encoded host
    tier) against the jitted reference from the converted state: losses
    within rtol 1e-5, index state and counters bitwise, DEVICE tables and
    arenas within the fp32 tolerance, the host payload within one int8 code
    and its sideband within rtol 1e-5 / atol 1e-7."""
    cfg = dict(SHAPE, device_budget_bytes=BUDGET, host_precision=host,
               arena_precision="int8" if host == "int8" else "fp32")
    jmodel, tmodel = JDLRM(JDLRMConfig(**cfg)), DLRM(DLRMConfig(**cfg))
    assert tmodel.collection.plan.summary() == jmodel.collection.plan.summary()
    assert set(tmodel.collection.device_slabs) == {"f0", "f1"}
    assert set(tmodel.collection.cached_slabs) == {"f2"}
    jstate = jmodel.init(jax.random.PRNGKey(0))
    tstate = convert.state_from_numpy(jax_to_numpy(jstate), device="cpu",
                                      collection=tmodel.collection)
    jstep = jax.jit(jmodel.train_step)
    for step in range(5):
        b = _batch(step)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tmodel.train_step(tstate, _tt(b))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=RTOL, atol=0)
        for key in ("cache_misses", "cache_evictions", "uniq_overflows"):
            assert int(tm[key]) == int(jm[key]), key
        for key in ("host_moved_rows", "host_row_bytes", "slab_hits"):
            assert {k: int(v) for k, v in tm[key].items()} == \
                {k: int(v) for k, v in jm[key].items()}, key
    assert int(tm["cache_evictions"]) > 0
    want, got = jax_to_numpy(jmodel.flush(jstate)), convert.to_numpy(tmodel.flush(tstate))
    _close(want["params"], got["params"], "params")
    for name in ("f0", "f1"):
        _close(want["emb"]["slabs"][name], got["emb"]["slabs"][name], name)
    jslab, tslab = want["emb"]["slabs"]["f2"], got["emb"]["slabs"]["f2"]
    assert_tree_equal(jslab["cache"], tslab["cache"], "cache", skip=("cached_rows",))
    _assert_arena_close(jslab["cache"]["cached_rows"], tslab["cache"]["cached_rows"], "arena")
    assert tslab["full"]["codec"] == jslab["full"]["codec"] == host
    if host == "fp32":
        _close(jslab["full"]["data"], tslab["full"]["data"], "host table")
    else:
        _codes_close(jslab["full"]["data"]["weight"], tslab["full"]["data"]["weight"], "payload")
        _close(jslab["full"]["sideband"], tslab["full"]["sideband"], "sideband", atol=1e-7)


@pytest.mark.parametrize("host", ["fp32", "int8"])
def test_mixed_plan_trains_and_serves_end_to_end(host):
    """Trainer then ServeEngine over a budget plan; the trained resident
    rows equal the flushed host tier's (bitwise for fp32, within one int8
    quantization step for int8)."""
    from repro_torch.serve.engine import ServeEngine

    model = DLRM(DLRMConfig(**dict(SHAPE, device_budget_bytes=BUDGET, host_precision=host)))
    placements = {p.placement for p in model.collection.plan.placements.values()}
    assert {col.Placement.DEVICE, col.Placement.CACHED} <= placements
    assert model.collection.device_bytes()["device_total"] <= BUDGET
    trainer = Trainer(TrainerConfig(max_steps=5), init_fn=lambda: model.init(0, device="cpu"),
                      step_fn=model.train_step, make_batch=_batch, flush_fn=model.flush,
                      device="cpu")
    state = trainer.run()
    assert trainer.history and np.isfinite(trainer.history[-1]["loss"])
    assert trainer.history[-1]["host_wire_bytes"] > 0
    fb = model.features(_tt(_batch(99)))
    emb, _, rows = model.collection.lookup(state["emb"], fb, writeback=False)
    ref = model.collection.dense_reference(model.collection.flush(emb), fb)
    for f in fb.features:
        if host == "fp32" or f in model.collection.device_slabs:
            assert torch.equal(rows[f], ref[f]), f
        else:
            torch.testing.assert_close(rows[f], ref[f], rtol=0, atol=0.01)
    pad = {"dense": np.zeros((13,), np.float32), "sparse": np.zeros((3,), np.int32),
           "label": np.zeros((), np.float32)}
    eng = ServeEngine(model.serve_step, dict(state, emb=emb), batch_size=16, pad_example=pad,
                      device="cpu")
    scores = eng.score(_batch(1, batch=7))
    assert scores.shape == (7,) and np.isfinite(scores).all()


def test_train_launcher_host_precision_matches_reference_launcher(capsys, monkeypatch):
    """``launch/train.py --host-precision int8`` holds the reference
    launcher's counters: the same hits, misses and (int8-row) host wire
    bytes per step, losses within rtol 1e-5."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train

    runs = []

    class Recorded(jtrain.Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            runs.append(self)

    monkeypatch.setattr(jtrain, "Trainer", Recorded)
    argv = ["--arch", "dlrm-criteo", "--steps", "3", "--batch", "16", "--host-precision", "int8"]
    monkeypatch.setattr("sys.argv", ["train", *argv, "--use-pallas-plan"])
    jtrain.main()
    want_out = capsys.readouterr().out
    jcfg = JDLRMConfig(vocab_sizes=(100_000, 50_000, 20_000), embed_dim=32, batch_size=16,
                       cache_ratio=0.02, lr=0.3, bottom_mlp=(64, 32), top_mlp=(64,),
                       host_precision="int8", use_pallas_plan=True)
    init = jax_to_numpy(JDLRM(jcfg).init(jax.random.PRNGKey(0)))
    monkeypatch.setattr(DLRM, "init", lambda self, seed, counts=None, device=None:
                        convert.state_from_numpy(init, device=device))
    got = train.main(["--device", "cpu", *argv])
    got_out = capsys.readouterr().out
    want = runs[0].history
    for g, w in zip(got.history, want):
        for key in ("cache_hits", "cache_misses", "host_wire_bytes"):
            assert g[key] == w[key], key
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=RTOL, atol=0)
    assert len(got.history) == len(want) == 3
    pattern = r"host tier \(int8\): .*"
    assert re.search(pattern, got_out).group(0) == re.search(pattern, want_out).group(0)


@pytest.mark.parametrize("flags", [
    ("--arch", "dlrm-avazu"),
    ("--cache-policy", "lru"),
    ("--cache-policy", "runtime_lfu", "--arch", "fm"),
    ("--obs-annotate", "--history-limit", "2", "--obs-dir"),
])
def test_train_launcher_flags_match_reference_launcher(flags, capsys, monkeypatch, tmp_path):
    """``--arch dlrm-avazu``, ``--cache-policy``, ``--obs-annotate`` and
    ``--history-limit`` parse as the reference launcher's do: each run's
    trainer config and model config equal the reference's, field by field
    (the policy by name), and the per-step hits, misses and host wire bytes
    equal, losses within rtol 1e-5, from the reference's initial state."""
    from repro.launch import train as jtrain
    from repro.models.recsys_models import FMModel as JFMModel
    from repro_torch.launch import train
    from repro_torch.models.recsys_models import FMModel

    argv = ["--steps", "3", "--batch", "16", *flags]
    if argv[-1] == "--obs-dir":
        argv.append(str(tmp_path))
    runs = []

    class Recorded(jtrain.Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            runs.append(self)

    monkeypatch.setattr(jtrain, "Trainer", Recorded)
    monkeypatch.setattr("sys.argv", ["train", *(argv if "--arch" in argv else
                                                ["--arch", "dlrm-criteo", *argv]),
                                     "--use-pallas-plan"])
    jtrain.main()
    capsys.readouterr()
    want = runs[0]
    jmodel = want.step_fn.__wrapped__.__self__  # the reference's jitted bound train_step
    init = jax_to_numpy(jmodel.init(jax.random.PRNGKey(0)))
    tmodel = FMModel if isinstance(jmodel, JFMModel) else DLRM
    models = []
    orig_init = tmodel.init

    def converted_init(self, seed, counts=None, device=None):
        models.append(self)
        return convert.state_from_numpy(init, device=device)

    monkeypatch.setattr(tmodel, "init", converted_init)
    got = train.main(["--device", "cpu", *argv])
    monkeypatch.setattr(tmodel, "init", orig_init)
    for field in ("max_steps", "obs_annotate", "history_limit", "pipeline_depth"):
        assert getattr(got.cfg, field) == getattr(want.cfg, field), field
    tcfg, jcfg = models[0].cfg, jmodel.cfg
    for field in ("vocab_sizes", "embed_dim", "batch_size", "cache_ratio", "lr"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    assert (tcfg.policy and tcfg.policy.value) == (jcfg.policy and jcfg.policy.value)
    assert len(got.history) == len(want.history)
    for g, w in zip(got.history, want.history):
        for key in ("cache_hits", "cache_misses", "host_wire_bytes"):
            assert g[key] == w[key], key
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=RTOL, atol=0)
    if "--obs-dir" in argv:
        from repro_torch.obs import report

        steps = [r for r in report.load_records(got.hub.jsonl_path) if r.get("kind") == "step"]
        assert len(steps) == 3 and got.tracer.annotate


def test_avazu_configs_match_reference():
    """``configs/dlrm_avazu``: the paper's Avazu shape (13 fields, 9 445 823
    rows, batch 65 536: the single arena holds one batch's 851 968 unique
    rows) with the reference's sizes, and the SMOKE config's one training
    step within rtol 1e-5 of the reference's ``smoke()`` loss."""
    from repro.configs import dlrm_avazu as jav
    from repro.configs import shapes as jshapes
    from repro_torch.configs import dlrm_avazu as av
    from repro_torch.configs import shapes

    assert shapes.AVAZU_VOCABS == jshapes.AVAZU_VOCABS and sum(shapes.AVAZU_VOCABS) == 9_445_823
    assert shapes._AVAZU_BASE == jshapes._AVAZU_BASE
    for field in ("vocab_sizes", "n_dense", "embed_dim", "batch_size", "cache_ratio", "lr",
                  "max_unique_per_step", "arena_precision", "bottom_mlp", "top_mlp"):
        assert getattr(av.CONFIG, field) == getattr(jav.CONFIG, field), field
    spec = DLRM(av.CONFIG).collection.cached_slabs[SHARED_ARENA]
    assert (spec.vocab, spec.capacity, spec.unique_size()) == (9_445_823, 851_968, 851_968)
    assert JDLRM(jav.CONFIG).collection.cached_slabs[SHARED_ARENA].capacity == spec.capacity

    want = jav.smoke()
    smoke = {f: getattr(av.SMOKE, f) for f in ("vocab_sizes", "n_dense", "embed_dim",
                                                "batch_size", "cache_ratio", "lr",
                                                "bottom_mlp", "top_mlp")}
    init = jax_to_numpy(JDLRM(JDLRMConfig(**smoke)).init(jax.random.PRNGKey(0)))
    model = DLRM(av.SMOKE)
    state = convert.state_from_numpy(init, device="cpu")
    b = synth.sparse_batch(synth.ZipfSparseSpec(vocab_sizes=av.SMOKE.vocab_sizes, n_dense=8),
                           8, 0, 0)
    _, m = model.train_step(state, _tt(b))
    assert want["finite"] and np.isfinite(float(m["loss"]))
    np.testing.assert_allclose(float(m["loss"]), want["loss"], rtol=RTOL, atol=0)
