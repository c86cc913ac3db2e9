"""Structured metrics hub (port of ``repro.obs.hub``): typed instruments
(exact-int counters over the cumulative int32 device counters, last-value
gauges, fixed-bucket histograms) and a JSONL sink.

The cache's counters (hits, misses, host rows moved) are cumulative int32
device state that wraps past 2^31; :class:`ExactCounter` rebuilds exact
Python-int totals from modulo-2^32 deltas, and
:meth:`MetricsHub.observe_embedding_metrics` is the one place that knows
which families a ``collection.metrics`` dict carries.  Every fetch of
counter leaves is ONE batched ``.cpu()`` copy.

Records are written with sorted keys and every wall-clock-dependent field
under the reserved ``"wall"`` key, so identical runs emit identical files
modulo that subtree.  ``python -m repro_torch.obs.report`` renders them.
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import IO, Any, Dict, List, Mapping, Optional, Tuple, Union

import torch

from repro_torch.obs.hist import FixedHistogram

__all__ = ["ExactCounter", "Gauge", "MetricsHub", "fetch_ints"]

_WRAP = 1 << 32


def fetch_ints(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """Host ints for a dict of scalar counters or one-level dicts of them,
    fetched with one device-to-host copy."""
    flat: List[Tuple[str, Optional[str], Any]] = []
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.extend((k, kk, vv) for kk, vv in v.items())
        else:
            flat.append((k, None, v))
    if not flat:
        return {}
    dev = next((v.device for *_, v in flat if isinstance(v, torch.Tensor)), torch.device("cpu"))
    vals = torch.stack(
        [torch.as_tensor(v, device=dev).reshape(()).to(torch.int64) for *_, v in flat]
    ).cpu().tolist()
    out: Dict[str, Any] = {}
    for (k, kk, _), v in zip(flat, vals):
        if kk is None:
            out[k] = v
        else:
            out.setdefault(k, {})[kk] = v
    return out


def _as_int_map(value: Any) -> Dict[str, int]:
    """Normalize a cumulative observation (scalar or per-key mapping) to
    ``{key: int}`` (a single scalar keys as "")."""
    if isinstance(value, Mapping):
        return {k: int(v) for k, v in fetch_ints({"m": value}).get("m", {}).items()}
    return {"": int(fetch_ints({"v": value})["v"])}


class ExactCounter:
    """Wrap-free exact totals over cumulative int32 device counters.

    :meth:`observe` takes a CUMULATIVE counter (or per-slab mapping) and
    adds its modulo-2^32 delta, times ``unit`` when given (bytes = rows x
    encoded row size).  Repeated observation of the same values adds 0."""

    def __init__(self, name: str = ""):
        self.name = name
        self._prev: Dict[str, int] = {}
        self._total = 0

    def add(self, n: int) -> int:
        """A direct host-side increment (already an exact int)."""
        self._total += int(n)
        return self._total

    def observe(
        self, cumulative: Any, unit: Optional[Union[int, Mapping[str, Any]]] = None
    ) -> int:
        cur = _as_int_map(cumulative)
        units: Optional[Dict[str, int]] = None
        if unit is not None:
            units = _as_int_map(unit) if isinstance(unit, Mapping) else {k: int(unit) for k in cur}
        for k, v in cur.items():
            delta = (v - self._prev.get(k, 0)) % _WRAP
            self._prev[k] = v
            self._total += delta * (units[k] if units is not None else 1)
        return self._total

    @property
    def value(self) -> int:
        return self._total


class Gauge:
    """Last-value instrument (floats: hit rate, imbalance, loss)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.value: float = 0.0

    def set(self, v: float) -> float:
        self.value = float(v)
        return self.value


# (record_key, counts_key, unit_key): per-slab cumulative int32 counts,
# optionally priced by a per-unit byte size.
_CUMULATIVE_FAMILIES = (
    ("cache_hits", "slab_hits", None),
    ("cache_misses", "slab_misses", None),
    ("host_moved_rows", "host_moved_rows", None),
    ("host_wire_bytes", "host_moved_rows", "host_row_bytes"),
    ("exchange_routed_lanes", "exchange_routed_lanes", None),
    ("exchange_bytes", "exchange_routed_lanes", "exchange_lane_bytes"),
    ("exchange_id_bytes", "exchange_routed_lanes", "exchange_id_lane_bytes"),
    ("exchange_row_bytes", "exchange_routed_lanes", "exchange_row_lane_bytes"),
    ("refresh_swaps_exact", "slab_refresh_swaps", None),
    ("refresh_rows_moved_exact", "slab_refresh_rows", None),
    ("slab_tier_promotions", "slab_tier_promotions", None),
    ("slab_tier_demotions", "slab_tier_demotions", None),
)


class MetricsHub:
    """Counter / gauge / histogram registry plus a per-run JSONL sink
    (``run_dir=None``: no sink, instruments still accumulate).

    :meth:`snapshot` captures every instrument's value; :meth:`delta`
    subtracts an earlier snapshot's counters (per-interval rates off one
    hub).  As a context manager the hub closes its sink on exit."""

    def __init__(self, run_dir: Optional[str] = None, run: str = "run", timestamps: bool = True):
        self.run = run
        self.timestamps = timestamps
        self.jsonl_path: Optional[str] = None
        self._sink: Optional[IO[str]] = None
        self._counters: Dict[str, ExactCounter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, FixedHistogram] = {}
        if run_dir is not None:
            os.makedirs(run_dir, exist_ok=True)
            self.jsonl_path = os.path.join(run_dir, f"{run}.jsonl")
            self._sink = open(self.jsonl_path, "w")
            self.log("meta", {"run": run, "argv": list(sys.argv[1:])})

    def counter(self, name: str) -> ExactCounter:
        if name not in self._counters:
            self._counters[name] = ExactCounter(name)
        return self._counters[name]

    def gauge(self, name: str) -> Gauge:
        if name not in self._gauges:
            self._gauges[name] = Gauge(name)
        return self._gauges[name]

    def histogram(self, name: str, bounds: Optional[tuple] = None) -> FixedHistogram:
        """The named histogram, built on first use with ``bounds`` (the
        latency buckets by default)."""
        if name not in self._hists:
            self._hists[name] = (FixedHistogram(bounds=bounds) if bounds is not None
                                 else FixedHistogram.latency())
        return self._hists[name]

    def observe_embedding_metrics(self, metrics: Mapping[str, Any]) -> Dict[str, int]:
        """Feed one observation of a ``collection.metrics`` dict; returns the
        exact-int record of the families present (one host copy)."""
        wanted = {
            key
            for _, counts_key, unit_key in _CUMULATIVE_FAMILIES
            for key in (counts_key, unit_key)
            if key is not None and key in metrics
        }
        fetched = fetch_ints({k: metrics[k] for k in wanted})
        out: Dict[str, int] = {}
        for record_key, counts_key, unit_key in _CUMULATIVE_FAMILIES:
            if counts_key not in fetched or (unit_key is not None and unit_key not in fetched):
                continue
            unit = fetched[unit_key] if unit_key is not None else None
            out[record_key] = self.counter(record_key).observe(fetched[counts_key], unit=unit)
        if "cache_hits" in out and "cache_misses" in out:
            h, m = out["cache_hits"], out["cache_misses"]
            out["hit_rate_exact"] = h / max(h + m, 1)
        return out

    def log(self, kind: str, payload: Mapping[str, Any], wall: Optional[Mapping[str, Any]] = None) -> None:
        """Append one record; wall-clock-dependent fields go in ``wall``."""
        if self._sink is None:
            return
        rec: Dict[str, Any] = {"kind": kind, **payload}
        w = dict(wall) if wall else {}
        if self.timestamps:
            w["ts"] = time.time()
        if w:
            rec["wall"] = w
        self._sink.write(json.dumps(rec, sort_keys=True) + "\n")
        self._sink.flush()

    def log_hist(self, name: str, hist: Optional[FixedHistogram] = None) -> None:
        """A named histogram record (``hist``, else the registry's; none:
        no record).  Its counts are wall-clock, so all of it sits under
        ``wall``."""
        h = hist if hist is not None else self._hists.get(name)
        if h is None:
            return
        self.log("hist", {"name": name}, wall={"hist": h.to_dict()})

    def log_spans(self, tracer) -> None:
        summary = tracer.stage_summary()
        self.log(
            "spans",
            {"counts": {k: v["count"] for k, v in summary.items()}},
            wall={"stages": summary},
        )

    def snapshot(self) -> Dict[str, Any]:
        return {
            "counters": {k: c.value for k, c in sorted(self._counters.items())},
            "gauges": {k: g.value for k, g in sorted(self._gauges.items())},
            "hists": {k: h.to_dict() for k, h in sorted(self._hists.items())},
        }

    def delta(self, prev: Mapping[str, Any]) -> Dict[str, int]:
        """Counter movement since an earlier :meth:`snapshot`."""
        base = prev.get("counters", {})
        return {k: c.value - int(base.get(k, 0)) for k, c in sorted(self._counters.items())}

    def close(self) -> None:
        if self._sink is not None:
            self.log("summary", {"counters": self.snapshot()["counters"]})
            self._sink.close()
            self._sink = None

    def __enter__(self) -> "MetricsHub":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
