"""The harness is driven by data: every cell of ``BENCHMARK.json`` resolves
its configuration, traffic mix, mode, model adapter, reference, limits and
metric readers by name, a cell written as new files beside a copy of the
layout resolves with no file there edited, and ``BENCHMARK.json`` keeps the
shape the benchmark's contract asks of it."""
import json
import re
import shutil

import pytest

from portbench.lib import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(harness.ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_every_cell_resolves_its_files():
    bench = _bench()
    for w in bench["workloads"]:
        cell = harness.resolve(bench, w["name"])
        assert callable(cell["mode"].run) and callable(cell["mode"].control)
        assert hasattr(cell["model"], "Program")
        assert callable(cell["reference"].train_readings)
        assert cell["limits"], w["name"]
        assert cell["end_to_end"] and cell["per_layer"], w["name"]
        assert "setup_s" in [m["name"] for m in cell["end_to_end"]]
        for m in cell["end_to_end"] + cell["per_layer"]:
            assert callable(m["reader"].read), m["name"]


def test_a_new_cell_is_new_files_only(tmp_path):
    root = tmp_path / "portbench"
    shutil.copytree(harness.BENCH, root, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file()}
    bench = _bench()
    cfg = json.loads((root / "configs" / "dlrm-criteo.json").read_text())
    (root / "configs" / "dlrm-criteo-small.json").write_text(
        json.dumps(dict(cfg, batch_size=4096)))
    (root / "traffic" / "zipf-low-skew.json").write_text(json.dumps(
        {"generator": "zipf", "mode": "pipelined", "zipf_a": 1.05, "label_noise": 0.3}))
    (root / "modes" / "pipelined.py").write_text(
        "def run(r):\n    raise NotImplementedError\n\n\n"
        "def control(r, count):\n    raise NotImplementedError\n")
    (root / "metrics" / "plan_ms.train.py").write_text(
        "def read(rec):\n    return rec.get('plan_ms')\n")
    (root / "limits" / "criteo-small-low-skew.json").write_text('{"loss_gap": 1e-6}')
    bench["configs"].append({"name": "dlrm-criteo-small", "source": "https://example.org",
                             "file": "portbench/configs/dlrm-criteo-small.json",
                             "reduced": ["batch_size"], "why": "a test"})
    bench["workloads"].append({"name": "criteo-small-low-skew", "config": "dlrm-criteo-small",
                               "traffic": "zipf-low-skew", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "plan_ms.train", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "cache",
                               "moves": "train_samples_per_s",
                               "workloads": ["criteo-small-low-skew"]})
    cell = harness.resolve(bench, "criteo-small-low-skew", root=root)
    assert cell["cfg"]["batch_size"] == 4096 and cell["mix"]["zipf_a"] == 1.05
    assert cell["mode"].__name__.endswith("pipelined")
    assert [m["name"] for m in cell["per_layer"]] == ["plan_ms.train"]
    assert cell["per_layer"][0]["reader"].read({"plan_ms": 3.0}) == 3.0
    assert [m["name"] for m in cell["end_to_end"]] == ["setup_s"]
    after = {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file()}
    assert all(after[p] == b for p, b in before.items())  # nothing there was edited


def test_an_unknown_cell_or_file_is_refused(tmp_path):
    bench = _bench()
    with pytest.raises(KeyError):
        harness.resolve(bench, "no-such-cell")
    root = tmp_path / "portbench"
    shutil.copytree(harness.BENCH, root, ignore=shutil.ignore_patterns("__pycache__"))
    (root / "limits" / "avazu-train-zipf.json").unlink()
    with pytest.raises(FileNotFoundError):
        harness.resolve(bench, "avazu-train-zipf", root=root)


def test_benchmark_json_keeps_the_contract_shape():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"] and bench["command"][1] == "portbench/run.py"
    assert 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    metrics = bench["end_to_end"] + bench["per_layer"]
    names += [m["name"] for m in metrics]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (harness.ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    e2e = {m["name"] for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
        mine = [m for m in metrics if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in [m["name"] for m in mine]
        assert len([m for m in mine if m["name"] in e2e]) >= 2
        assert any(m["name"] not in e2e for m in mine)
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
        for w in m.get("workloads", []):
            cell = next(c for c in bench["workloads"] if c["name"] == w)
            mover = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
            assert cell["name"] in mover.get("workloads", [cell["name"]])
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
