"""The port's metrics hub instruments (``obs/hub.py``: ``Gauge``,
``gauge``, ``histogram``, ``snapshot`` / ``delta``, the context manager)
and its run renderer (``obs/report.py``) against ``repro.obs``: the same
calls give the same snapshots and the same JSONL modulo the ``wall``
subtree, and the two renderers give the same text and the same ``--json``
summary for the same stream, the reference's ``tests/test_obs.py`` stream
and the port trainer's own."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.obs import MetricsHub as JMetricsHub
from repro.obs import Tracer as JTracer
from repro.obs import report as jreport
from repro_torch.obs import FixedHistogram, Gauge, MetricsHub, Tracer, report


def _wrapped(x: int) -> int:
    return (x + 2**31) % 2**32 - 2**31


def _drive(hub, tracer, as_array):
    """The reference test's stream (three steps of wrapped per-slab hit and
    miss counters, a step-time histogram, one span), plus gauges."""
    for step in range(3):
        out = hub.observe_embedding_metrics(
            {"slab_hits": {"s": as_array(_wrapped(10 * (step + 1)))},
             "slab_misses": {"s": as_array(_wrapped(2 * (step + 1)))}})
        hub.histogram("step_time_s").observe(1e-3 * (step + 1))
        hub.gauge("loss").set(0.5 / (step + 1))
        hub.log("step", {"step": step, "loss": 0.5 / (step + 1), **out},
                wall={"time_s": 1e-3})
    with tracer.span("compute"):
        pass
    hub.log_hist("step_time_s")
    hub.log_spans(tracer)


def _strip_wall(path):
    out = []
    for line in open(path).read().splitlines():
        rec = json.loads(line)
        rec.pop("wall", None)
        out.append(rec)
    return out


def _both(tmp_path):
    with JMetricsHub(run_dir=str(tmp_path / "jax"), run="r") as jhub:
        _drive(jhub, JTracer(), lambda x: jnp.asarray(x, jnp.int32))
    with MetricsHub(run_dir=str(tmp_path / "port"), run="r") as hub:
        _drive(hub, Tracer(), lambda x: torch.tensor(x, dtype=torch.int32))
    assert hub._sink is None and jhub._sink is None  # closed on exit
    return jhub, hub


def test_hub_streams_and_snapshot_match_reference(tmp_path):
    jhub, hub = _both(tmp_path)
    assert _strip_wall(hub.jsonl_path) == _strip_wall(jhub.jsonl_path)
    snap, jsnap = hub.snapshot(), jhub.snapshot()
    assert snap == jsnap
    assert snap["counters"] == {"cache_hits": 30, "cache_misses": 6}
    assert snap["gauges"] == {"loss": 0.5 / 3}
    assert snap["hists"]["step_time_s"]["count"] == 3


def test_gauge_histogram_and_delta_match_reference():
    hubs = (MetricsHub(), JMetricsHub())
    for h in hubs:
        h.counter("x").add(10)
        g = h.gauge("imbalance")
        assert h.gauge("imbalance") is g and g.set(np.float32(1.25)) == 1.25
        h.histogram("b", bounds=(1.0, 2.0)).observe(1.5)
        h.histogram("lat").observe(3e-3)
    snaps = [h.snapshot() for h in hubs]
    assert snaps[0] == snaps[1]
    for h in hubs:
        h.counter("x").add(5)
        h.counter("y").add(2)
    assert hubs[0].delta(snaps[0]) == hubs[1].delta(snaps[1]) == {"x": 5, "y": 2}
    assert isinstance(hubs[0].gauge("imbalance"), Gauge)
    assert hubs[0].histogram("b").bounds == (1.0, 2.0)


def test_sinkless_hub_writes_nothing(tmp_path):
    with MetricsHub() as hub:
        hub.counter("c").add(3)
        hub.log("step", {"step": 0})
        hub.log_hist("never_made")
    assert hub.jsonl_path is None and hub.snapshot()["counters"]["c"] == 3
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("which", ["jax", "port"])
def test_report_matches_reference_on_the_same_stream(tmp_path, capsys, which):
    """Both renderers on each hub's stream: the same text and the same
    ``--json`` summary."""
    _both(tmp_path)
    path = str(tmp_path / which / "r.jsonl")
    out = {}
    for name, mod in (("port", report), ("jax", jreport)):
        assert mod.main([path]) == 0
        text = capsys.readouterr().out
        assert mod.main([path, "--json"]) == 0
        out[name] = (text, json.loads(capsys.readouterr().out))
    assert out["port"] == out["jax"]
    text, summary = out["port"]
    assert "cache: 30 hits / 6 misses (exact)" in text
    assert "compute" in text and "step_time_s" in text
    assert summary["train"]["n_steps"] == 3 and summary["counters"]["cache_hits"] == 30
    assert summary["latency"]["step_time_s"]["count"] == 3
    records = report.load_records(path)
    assert report.summarize(records) == jreport.summarize(records)
    assert report.render(summary) == jreport.render(summary)
    assert report.sparkline([1, 2, 3]) == jreport.sparkline([1, 2, 3])


def test_report_renders_the_port_trainers_stream(tmp_path, capsys):
    """A port ``Trainer`` run with ``obs_dir`` and ``history_limit``: the
    JSONL holds every step, the memory only the tail; the port's report
    equals the reference's on it."""
    from repro_torch.train.trainer import Trainer, TrainerConfig

    def step_fn(state, batch):
        return state + 1, {"loss": torch.tensor(0.5)}

    tr = Trainer(TrainerConfig(max_steps=6, obs_dir=str(tmp_path), history_limit=2),
                 init_fn=lambda: torch.zeros((), dtype=torch.int32), step_fn=step_fn,
                 make_batch=lambda s: {"x": np.full((2,), s)}, device="cpu")
    tr.run()
    assert [r["step"] for r in tr.history] == [4, 5]
    records = report.load_records(tr.hub.jsonl_path)
    assert [r["step"] for r in records if r.get("kind") == "step"] == list(range(6))
    kinds = [r.get("kind") for r in records]
    assert kinds[0] == "meta" and "hist" in kinds and kinds[-1] == "summary"
    assert report.summarize(records) == jreport.summarize(records)
    assert report.main([tr.hub.jsonl_path, "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["train"]["n_steps"] == 6


def test_report_rejects_an_empty_stream(tmp_path):
    path = tmp_path / "empty.jsonl"
    path.write_text("\n")
    with pytest.raises(SystemExit, match="no records"):
        report.main([str(path)])
    assert FixedHistogram.latency().count == 0
