"""What the metric readers share: each ``portbench/metrics/<name>.py`` is
one of these, bound to its record's kind (``train`` or ``serve``), so that
a metric reports only in the cells whose mode it belongs to.  A reader
returns None where its record holds nothing to read."""
from __future__ import annotations

from typing import Callable, Mapping, Optional

import numpy as np

from portbench.lib import flops

Reader = Callable[[Mapping], Optional[float]]


def _of(kind: str, fn: Reader) -> Reader:
    return lambda rec: fn(rec) if rec["kind"] == kind else None


def setup_s(rec: Mapping) -> float:
    return float(rec["setup_s"])


def rate(kind: str) -> Reader:
    """Items (samples or rows) over the window's wall time."""
    return _of(kind, lambda rec: rec["items"] / rec["window_s"])


def p95_ms(kind: str) -> Reader:
    """The 95th percentile of every step or request of the window, in ms."""
    return _of(kind, lambda rec: float(np.percentile(rec["times_s"], 95)) * 1e3)


def mfu(kind: str) -> Reader:
    """Useful flops over the window, as a share (%) of the card's fp32 peak."""
    def read(rec):
        peak = flops.peak(rec["device_kind"], "fp32_flops")
        if peak is None:
            return None
        return 100.0 * rec["flops_per_step"] * rec["steps"] / rec["window_s"] / peak
    return _of(kind, read)


def hit_rate(kind: str) -> Reader:
    """Id hits over all lookups of the window (%), from the cache's counters."""
    def read(rec):
        c = rec["counters"]
        total = c["hits"] + c["misses"]
        return 100.0 * c["hits"] / total if total else None
    return _of(kind, read)


def wire_bytes(kind: str) -> Reader:
    """Bytes over the host link a step or request: rows moved times a row's bytes."""
    return _of(kind, lambda rec: rec["counters"]["moved_rows"] * rec["row_bytes"] / rec["steps"])


def idle_share(kind: str) -> Reader:
    """The traced window's time with no device op (%)."""
    def read(rec):
        t = rec.get("trace")
        return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t else None
    return _of(kind, read)


def roofline(kind: str, kernel: str, bytes_key: str) -> Reader:
    """A kernel's bound (its bytes at the card's peak bandwidth) over its mean
    traced time a launch (%)."""
    def read(rec):
        t = rec.get("trace")
        peak = flops.peak(rec["device_kind"], "hbm_bytes_per_s")
        if not t or peak is None:
            return None
        hits = [v for name, v in t["kernels"].items() if kernel in name]
        launches, seconds = sum(c for c, _ in hits), sum(s for _, s in hits)
        if not launches or seconds <= 0:
            return None
        return 100.0 * (rec[bytes_key] / peak) / (seconds / launches)
    return _of(kind, read)
