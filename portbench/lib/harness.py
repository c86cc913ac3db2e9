"""Runs one cell once: resolves it by name, drives its mode, reads its
metrics and prints the result line.

Everything that belongs to one configuration, traffic mix, mode or metric
is a file of its own, found by the name ``BENCHMARK.json`` uses:

* a configuration: the ``file`` of its ``configs`` entry (sizes, sources,
  and ``model``, which names ``portbench/models/<model>.py``, the program's
  adapter, and ``portbench/reference/<model>.py``, its plain reference);
* a traffic mix: ``portbench/traffic/<mix>.json`` (its ``generator``, read
  by ``lib/traffic.py``, and its ``mode``);
* a mode: ``portbench/modes/<mode>.py``, whose ``run(Run)`` returns the
  run's record;
* a metric: ``portbench/metrics/<name>.py``, whose ``read(record)`` gives
  its value or None where it finds nothing to read;
* a cell's limits: ``portbench/limits/<workload>.json``, one per number
  its checks compare.

With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones; ``correct`` holds when every compared
number is within its limit and no step or request failed.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import statistics
import sys
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional

import torch

__all__ = ["ROOT", "Run", "execute", "load", "main", "resolve", "sync"]

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, compared whole


@dataclasses.dataclass
class Run:
    """What a mode gets: the resolved cell and the run's arguments."""

    workload: str
    cfg: Dict[str, Any]
    mix: Dict[str, Any]
    limits: Dict[str, float]
    model: Any  # portbench/models/<model>.py
    reference: Any  # portbench/reference/<model>.py
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float  # perf_counter at process start
    hooks: Dict[str, Callable] = dataclasses.field(default_factory=dict)  # tests' faults


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def load(kind: str, name: str, root: Path = BENCH):
    """The module ``<root>/<kind>/<name>.py``."""
    path = root / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind} file {path}")
    mod_name = f"portbench_{kind}_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def resolve(bench: Mapping, workload: str, root: Path = BENCH) -> Dict[str, Any]:
    """Every file of a cell, loaded: its config, mix, mode, model adapter,
    reference, limits, and its metrics' names, units and readers."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = _json(root.parent / configs[cell["config"]]["file"])
    mix = _json(root / "traffic" / f"{cell['traffic']}.json")

    def metrics(kind: str) -> List[Dict[str, Any]]:
        out = []
        for m in bench[kind]:
            if workload in m.get("workloads", [workload]):
                out.append({"name": m["name"], "unit": m["unit"],
                            "reader": load("metrics", m["name"], root)})
        return out

    return {
        "cell": cell, "cfg": cfg, "mix": mix,
        "mode": load("modes", mix["mode"], root),
        "model": load("models", cfg["model"], root),
        "reference": load("reference", cfg["model"], root),
        "limits": _json(root / "limits" / f"{workload}.json"),
        "end_to_end": metrics("end_to_end"), "per_layer": metrics("per_layer"),
    }


def _finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def execute(cell: Mapping[str, Any], seed: int, seconds: float, trace: bool,
            device: torch.device, t0: float, hooks: Optional[Dict[str, Callable]] = None
            ) -> Dict[str, Any]:
    """Drive a resolved cell once; the result line as a dict (``checks``
    last, each compared number with its limit)."""
    run = Run(workload=cell["cell"]["name"], cfg=cell["cfg"], mix=cell["mix"],
              limits=cell["limits"], model=cell["model"], reference=cell["reference"],
              seed=int(seed), seconds=float(seconds), trace=bool(trace), device=device, t0=t0,
              hooks=dict(hooks or {}))
    rec = cell["mode"].run(run)
    if device.type == "cuda":
        rec["device_kind"] = torch.cuda.get_device_name(device)
    else:
        rec["device_kind"] = "cpu"
    metrics = {}
    for m in cell["per_layer" if trace else "end_to_end"]:
        value = m["reader"].read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {}
    for name, value in rec["checks"].items():
        if name in cell["limits"]:
            checks[name] = {"value": value, "limit": cell["limits"][name]}
    missing = sorted(set(cell["limits"]) - set(checks))
    if missing:
        raise KeyError(f"the mode compared no {missing}, which the cell's limits name")
    correct = rec["failed"] == 0 and all(
        _finite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": rec["device_kind"], "count": 1,
           "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    line: Dict[str, Any] = {"correct": bool(correct), "attempted": int(rec["attempted"]),
                            "failed": int(rec["failed"]), "metrics": metrics, "device": dev}
    if trace and rec.get("trace"):
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]
        line["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                             "idle_gaps": rec["trace"]["idle_gaps"]}
    times = rec["times_s"]
    line["window"] = {"seconds": rec["window_s"], "count": len(times),
                      "p50_ms": 1e3 * statistics.median(times), "max_ms": 1e3 * max(times)}
    line["notes"] = {k: v for k, v in rec["checks"].items() if k not in checks}
    line["checks"] = checks
    return line


def forbidden_modules(names: Optional[Iterable[str]] = None) -> List[str]:
    """The JAX stack or the JAX package among ``names`` (by default the
    modules this process has loaded), by whole top-level name."""
    return sorted({m.split(".")[0] for m in (sys.modules if names is None else names)}
                  & set(FORBIDDEN))


def main(args, t0: float) -> int:
    """The command's body (after ``run.py`` set the import path)."""
    bench_file = ROOT / "BENCHMARK.json"
    if not bench_file.is_file():
        print(f"no {bench_file}", file=sys.stderr)
        return 2
    cell = resolve(_json(bench_file), args.workload)
    chips = int(cell["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA card(s); this machine has {n}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # the configurations state fp32
    torch.backends.cudnn.allow_tf32 = False
    line = execute(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), t0)
    bad = forbidden_modules()
    if bad:
        print(f"this process loaded {bad}: the benchmark runs the port alone", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
