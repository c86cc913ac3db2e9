"""The port's examples against their JAX twins on the CPU: ``examples/
torch_quickstart.py``, ``torch_serve_recsys.py`` and ``torch_train_dlrm.py``
(the 8-rank ``torch_multi_device_scaling.py`` is in
``test_torch_examples_ranks.py``).

Each twin runs as written (``quickstart.py`` and ``serve_recsys.py`` have no
CLI; ``train_dlrm.py`` is cut through its own flags), and the port's example
runs with ``--device cpu`` at the same arguments, from the twin's initial
state converted by ``convert.state_from_numpy`` where a loss or a score
depends on the weights.  Held: hit / miss / eviction counts and host wire
bytes exactly, the placement plan's summary and ``device_bytes()`` exactly,
the printed count lines word for word, losses within rtol 1e-5 (scores
within rtol 1e-5, atol 1e-6); and a run cut at 10 steps and resumed to 20
bitwise an uninterrupted 20-step run.
"""
import os
import runpy
import sys

import jax
import numpy as np
import pytest
from torch_parity import EXAMPLES, jax_to_numpy, load_example

from repro.core import freq as jfreq
from repro_torch import convert
from repro_torch.models.dlrm import DLRM
from repro_torch.models.recsys_models import MINDModel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNT_KEYS = ("cache_hits", "cache_misses", "cache_evictions", "host_wire_bytes")
DEVICE_BYTES = ("device_total", "slow_tier_bytes", "host_bytes_saved", "budget_bytes")


def _copy(tree):
    """A numpy tree whose leaves own their memory (a jitted step may donate
    the JAX buffers a view would share)."""
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return np.array(tree) if isinstance(tree, np.ndarray) else tree


def _lines(out, drop=()):
    """Printed lines, without straggler reports (timing) and ``drop`` prefixes."""
    return [ln for ln in out.splitlines()
            if ln and not ln.startswith("[straggler]") and not ln.startswith(drop)]


def test_quickstart_matches_reference(capsys):
    """30 lookups of 4 096 Zipf ids through a 4 096-slot cache of 100 000
    rows: the same skew, hits, misses and evictions, every printed line
    equal, and the cache equals the dense table in both."""
    g = runpy.run_path(os.path.join(EXAMPLES, "quickstart.py"), run_name="jax_quickstart")
    want = capsys.readouterr().out
    got = load_example("torch_quickstart").main(["--device", "cpu"])
    assert _lines(capsys.readouterr().out) == _lines(want)
    c = g["state"].cache
    assert (got["hits"], got["misses"], got["evictions"]) == (
        int(c.hits), int(c.misses), int(c.evictions))
    assert got["misses"] > 0 and got["evictions"] > 0
    assert got["capacity"] == g["cfg"].capacity
    assert got["skew"] == jfreq.coverage(g["counts"], [0.01])[0.01]
    assert got["hit_rate"] == float(c.hit_rate())
    assert got["exact"] and len(got["step_ms"]) == 30


def test_serve_recsys_matches_reference(capsys, monkeypatch):
    """MIND at 200 000 items: 8 read-only batches through ``ServeEngine``,
    then one user against 100 000 candidates, from the twin's init: the same
    hits, misses and evictions, hit-rate and top-5 lines, and scores."""
    g = runpy.run_path(os.path.join(EXAMPLES, "serve_recsys.py"), run_name="jax_serve_recsys")
    want = capsys.readouterr().out
    jmodel = g["model"]
    init = _copy(jax_to_numpy(jmodel.init(jax.random.PRNGKey(0))))
    monkeypatch.setattr(MINDModel, "init", lambda self, seed, counts=None, device=None:
                        convert.state_from_numpy(init, device=device, collection=self.collection))
    got = load_example("torch_serve_recsys").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert _lines(out, ("online scoring",)) == _lines(want, ("online scoring",))
    m = jax_to_numpy(jmodel.collection.metrics(g["engine"].state["emb"]))
    assert got["hits"] == sum(int(v) for v in m["slab_hits"].values())
    assert (got["misses"], got["evictions"]) == (int(m["cache_misses"]),
                                                 int(m["cache_evictions"]))
    assert got["misses"] > 0
    assert got["hit_rate"] == float(m["hit_rate"])
    want_summary = g["engine"].stats.summary()
    assert (got["summary"]["requests"], got["summary"]["batches"]) == (
        want_summary["requests"], want_summary["batches"]) == (1600, 8)
    np.testing.assert_allclose(got["retrieval_scores"], np.asarray(g["scores"]), rtol=1e-5,
                               atol=1e-6)
    assert got["top5"] == g["top"].tolist()


def _reference_train(argv, monkeypatch):
    """The JAX twin's ``main`` at ``argv``: its trainers (in order), its
    models and each model's initial state (numpy)."""
    mod = load_example("train_dlrm")
    runs, models, inits = [], [], []

    def recorded(base):
        class Recorded(base):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                runs.append(self)
        return Recorded

    class RecordedDLRM(mod.DLRM):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            models.append(self)

        def init(self, rng, counts=None):
            state = super().init(rng, counts=counts)
            inits.append(_copy(jax_to_numpy(state)))
            return state

    monkeypatch.setattr(mod, "Trainer", recorded(mod.Trainer))
    monkeypatch.setattr(mod, "PipelinedTrainer", recorded(mod.PipelinedTrainer))
    monkeypatch.setattr(mod, "DLRM", RecordedDLRM)
    monkeypatch.setattr(sys, "argv", ["train_dlrm.py", *argv])
    mod.main()
    return runs, models, inits


def _same_history(got, want):
    assert [h["step"] for h in got] == [h["step"] for h in want]
    np.testing.assert_allclose([h["loss"] for h in got], [h["loss"] for h in want], rtol=1e-5,
                               atol=0)
    for key in COUNT_KEYS:
        assert [h[key] for h in got] == [h[key] for h in want], key


TRAIN_CASES = {
    "serial": [],
    "budget": ["--device-budget-mb", "20"],
    "int8": ["--host-precision", "int8"],
    "pipelined": ["--verify-pipeline", "--pipeline-depth", "2", "--cache-ratio", "0.05"],
}


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_dlrm_matches_reference(case, tmp_path, monkeypatch, capsys):
    """``train_dlrm.py --steps 8 --batch 256`` in the single-arena mode, the
    budget mode at 20 MB, an int8 host tier and ``--verify-pipeline`` at
    depth 2: the same plan, ``device_bytes()``, counts a step and printed
    count lines, losses within rtol 1e-5 from the twin's init."""
    base = ["--steps", "8", "--batch", "256", *TRAIN_CASES[case]]
    runs, models, inits = _reference_train(
        [*base, "--ckpt-dir", str(tmp_path / "jax")], monkeypatch)
    want = capsys.readouterr().out
    monkeypatch.setattr(DLRM, "init", lambda self, seed, counts=None, device=None:
                        convert.state_from_numpy(inits[0], device=device,
                                                 collection=self.collection))
    got = load_example("torch_train_dlrm").main(
        [*base, "--ckpt-dir", str(tmp_path / "port"), "--device", "cpu"])
    out = capsys.readouterr().out
    drop = ("loss ", "auc ", "pipelined (depth")  # 4-decimal floats and host times
    assert _lines(out, drop) == _lines(want, drop)
    assert got["plan"] == models[0].collection.plan.summary()
    dbytes = models[-1].collection.device_bytes()
    assert {k: got["device_bytes"][k] for k in DEVICE_BYTES} == {k: dbytes[k] for k in DEVICE_BYTES}
    assert got["host_precision"] == dict(models[-1].collection.host_precision)
    if case == "pipelined":
        assert got["verified"] and len(runs) == 2
        _same_history(got["serial_history"], runs[0].history)
    assert len(runs[-1].history) == 8
    _same_history(got["history"], runs[-1].history)
    if case == "budget":
        assert set(got["plan"].values()) >= {"device", "cached@0.0150"}
    if case == "int8":
        assert got["device_bytes"]["host_bytes_saved"] > 0


def test_train_dlrm_resume_is_bitwise_an_uninterrupted_run(tmp_path):
    """A run cut at 10 steps and run again to 20 from its checkpoint
    directory gives bitwise the losses and counts of one uninterrupted
    20-step run; the default checkpoint directory is the port's own."""
    ex = load_example("torch_train_dlrm")
    assert ex.DEFAULT_CKPT.startswith(os.path.join(ROOT, "build"))
    base = ["--batch", "256", "--device", "cpu"]
    cut = ex.main(["--steps", "10", "--ckpt-dir", str(tmp_path / "cut"), *base])
    resumed = ex.main(["--steps", "20", "--ckpt-dir", str(tmp_path / "cut"), *base])
    whole = ex.main(["--steps", "20", "--ckpt-dir", str(tmp_path / "whole"), *base])
    assert [h["step"] for h in resumed["history"]] == list(range(10, 20))
    for got, want in ((cut["history"], whole["history"][:10]),
                      (resumed["history"], whole["history"][10:])):
        assert [h["loss"] for h in got] == [h["loss"] for h in want]
        for key in (*COUNT_KEYS, "auc", "hit_rate"):
            assert [h[key] for h in got] == [h[key] for h in want], key
    assert whole["history"][-1]["cache_misses"] > 0
