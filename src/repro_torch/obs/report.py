"""Run-summary renderer for observability JSONL streams (a copy of
``repro.obs.report`` over the port's streams).

  PYTHONPATH=src python -m repro_torch.obs.report /tmp/obs/train.jsonl
  PYTHONPATH=src python -m repro_torch.obs.report /tmp/obs/serve.jsonl --json

Reads the records a :class:`repro_torch.obs.hub.MetricsHub` sink wrote
(``meta``, ``step`` one per trainer step, ``serve_batch``, ``spans``,
``hist``, ``summary``) and renders the run: loss and hit-rate trajectories
(sparklines), bytes/step for the host link and the shard exchange, the
per-stage span breakdown, and the latency percentile table.  ``--json``
emits the computed summary as machine-readable JSON instead (what CI
asserts on).  The renderer itself is stdlib and the port's histogram; it
needs no card.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.obs.hist import FixedHistogram

__all__ = ["load_records", "summarize", "render", "main"]

_SPARK = "▁▂▃▄▅▆▇█"


def sparkline(values: Sequence[float], width: int = 48) -> str:
    """Down-sampled unicode sparkline (empty string for no data)."""
    vals = [float(v) for v in values]
    if not vals:
        return ""
    if len(vals) > width:  # mean-pool into `width` buckets
        n = len(vals)
        vals = [
            sum(vals[i * n // width : (i + 1) * n // width])
            / max(1, (i + 1) * n // width - i * n // width)
            for i in range(width)
        ]
    lo, hi = min(vals), max(vals)
    span = hi - lo
    if span <= 0:
        return _SPARK[0] * len(vals)
    return "".join(_SPARK[int((v - lo) / span * (len(_SPARK) - 1))] for v in vals)


def load_records(path: str) -> List[Dict[str, Any]]:
    out = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise SystemExit(f"{path}:{i + 1}: not a JSONL record: {e}") from e
    return out


def _series(steps: List[Dict[str, Any]], key: str) -> List[float]:
    return [float(r[key]) for r in steps if key in r]


def _per_step(cumulative: List[float]) -> List[float]:
    """Per-step deltas of a cumulative series (first entry counts from 0)."""
    out, prev = [], 0.0
    for v in cumulative:
        out.append(v - prev)
        prev = v
    return out


def summarize(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold a record stream into the report's data model."""
    by_kind: Dict[str, List[Dict[str, Any]]] = {}
    for r in records:
        by_kind.setdefault(r.get("kind", "?"), []).append(r)

    out: Dict[str, Any] = {}
    meta = by_kind.get("meta", [])
    if meta:
        out["run"] = meta[0].get("run", "?")

    steps = sorted(by_kind.get("step", []), key=lambda r: r.get("step", 0))
    if steps:
        losses = _series(steps, "loss")
        hit = _series(steps, "hit_rate_exact") or _series(steps, "hit_rate")
        times = [
            float(r["wall"]["time_s"])
            for r in steps
            if isinstance(r.get("wall"), dict) and "time_s" in r["wall"]
        ]
        s: Dict[str, Any] = {
            "n_steps": len(steps),
            "first_step": steps[0].get("step"),
            "last_step": steps[-1].get("step"),
        }
        if losses:
            s["loss_first"], s["loss_last"] = losses[0], losses[-1]
            s["loss_series"] = losses
        if hit:
            s["hit_rate_last"] = hit[-1]
            s["hit_rate_series"] = hit
        if times:
            s["step_time_mean_s"] = sum(times) / len(times)
        for key in ("host_wire_bytes", "exchange_bytes", "exchange_id_bytes",
                    "exchange_row_bytes"):
            series = _series(steps, key)
            if series:
                s[f"{key}_total"] = int(series[-1])
                s[f"{key}_per_step"] = series[-1] / max(len(series), 1)
        for key in ("cache_hits", "cache_misses", "refresh_swaps_exact",
                    "refresh_rows_moved_exact"):
            series = _series(steps, key)
            if series:
                s[f"{key}_total"] = int(series[-1])
        out["train"] = s

    batches = by_kind.get("serve_batch", [])
    if batches:
        out["serve"] = {
            "n_batches": len(batches),
            "requests": int(batches[-1].get("requests", 0)),
        }

    spans = by_kind.get("spans", [])
    if spans:
        last = spans[-1]
        stages = (last.get("wall") or {}).get("stages", {})
        total = sum(v.get("total_s", 0.0) for v in stages.values()) or 1.0
        out["stages"] = {
            name: {
                "count": v.get("count", 0),
                "total_s": v.get("total_s", 0.0),
                "mean_ms": v.get("mean_ms", 0.0),
                "share": v.get("total_s", 0.0) / total,
            }
            for name, v in sorted(stages.items())
        }

    hists = {}
    for r in by_kind.get("hist", []):
        payload = (r.get("wall") or {}).get("hist")
        if payload is None:
            continue
        h = FixedHistogram.from_dict(payload)
        hists[r.get("name", "?")] = {
            "count": h.count,
            "mean_ms": 1e3 * h.mean,
            **{k: 1e3 * v for k, v in h.percentiles().items()},
            "max_ms": 1e3 * h.max,
        }
    if hists:
        out["latency"] = hists

    summaries = by_kind.get("summary", [])
    if summaries:
        out["counters"] = summaries[-1].get("counters", {})
    return out


def _fmt_bytes(n: float) -> str:
    for unit, div in (("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if abs(n) >= div:
            return f"{n / div:.2f} {unit}"
    return f"{n:.0f} B"


def render(summary: Dict[str, Any]) -> str:
    lines: List[str] = []
    lines.append(f"run: {summary.get('run', '?')}")

    t = summary.get("train")
    if t:
        lines.append(
            f"steps: {t['n_steps']} ({t.get('first_step')}..{t.get('last_step')})"
        )
        if "loss_first" in t:
            lines.append(
                f"loss: {t['loss_first']:.4f} -> {t['loss_last']:.4f}  "
                f"{sparkline(t.get('loss_series', []))}"
            )
        if "hit_rate_last" in t:
            lines.append(
                f"hit rate: {t['hit_rate_last']:.1%}  "
                f"{sparkline(t.get('hit_rate_series', []))}"
            )
        if "step_time_mean_s" in t:
            lines.append(f"step time: mean {t['step_time_mean_s'] * 1e3:.2f} ms")
        if "host_wire_bytes_total" in t:
            lines.append(
                f"host link: {_fmt_bytes(t['host_wire_bytes_total'])} total, "
                f"{_fmt_bytes(t['host_wire_bytes_per_step'])}/step"
            )
        if "exchange_bytes_total" in t:
            extra = ""
            if "exchange_id_bytes_total" in t:
                extra = (
                    f" (ids {_fmt_bytes(t['exchange_id_bytes_total'])}"
                    f" + rows {_fmt_bytes(t.get('exchange_row_bytes_total', 0))})"
                )
            lines.append(
                f"shard exchange: {_fmt_bytes(t['exchange_bytes_total'])} total, "
                f"{_fmt_bytes(t['exchange_bytes_per_step'])}/step{extra}"
            )
        if "cache_hits_total" in t:
            lines.append(
                f"cache: {t['cache_hits_total']} hits / "
                f"{t.get('cache_misses_total', 0)} misses (exact)"
            )
        if "refresh_swaps_exact_total" in t:
            lines.append(
                f"refresh: {t['refresh_swaps_exact_total']} swaps, "
                f"{t.get('refresh_rows_moved_exact_total', 0)} rows moved"
            )

    sv = summary.get("serve")
    if sv:
        lines.append(f"serve: {sv['n_batches']} batches, {sv['requests']} requests")

    stages = summary.get("stages")
    if stages:
        lines.append("")
        lines.append("stage breakdown (host wall-clock spans):")
        lines.append(f"  {'stage':<14}{'count':>8}{'total ms':>12}{'mean ms':>10}{'share':>8}")
        for name, v in stages.items():
            lines.append(
                f"  {name:<14}{v['count']:>8}{v['total_s'] * 1e3:>12.1f}"
                f"{v['mean_ms']:>10.2f}{v['share']:>8.1%}"
            )

    lat = summary.get("latency")
    if lat:
        lines.append("")
        lines.append("latency (fixed-bucket histogram bounds, ms):")
        lines.append(
            f"  {'name':<18}{'count':>8}{'mean':>9}{'p50':>9}{'p95':>9}"
            f"{'p99':>9}{'p999':>9}{'max':>9}"
        )
        for name, v in sorted(lat.items()):
            lines.append(
                f"  {name:<18}{v['count']:>8}{v['mean_ms']:>9.2f}{v['p50']:>9.2f}"
                f"{v['p95']:>9.2f}{v['p99']:>9.2f}{v['p999']:>9.2f}{v['max_ms']:>9.2f}"
            )
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report", description=__doc__
    )
    ap.add_argument("jsonl", help="run JSONL written by a MetricsHub sink")
    ap.add_argument("--json", action="store_true",
                    help="emit the computed summary as JSON (CI mode)")
    args = ap.parse_args(argv)
    records = load_records(args.jsonl)
    if not records:
        raise SystemExit(f"{args.jsonl}: no records")
    summary = summarize(records)
    if args.json:
        print(json.dumps(summary, indent=2, sort_keys=True, default=str))
    else:
        print(render(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
