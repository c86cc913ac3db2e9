"""Deterministic fixed-bucket latency histograms (copy of ``repro.obs.hist``).

The serving tier used to estimate percentiles from a seeded reservoir
(Vitter's Algorithm R): O(1) memory, but a reservoir is a *sample* — the tail
is under-weighted by construction (a p999 event has a 0.1% chance of being in
any given slot), and the estimate depends on the arrival order of samples.
A fixed-bucket histogram with log-spaced bounds fixes both at the same O(1)
memory: every observation is COUNTED (exact integer counts, nothing is ever
dropped or displaced), and a quantile query returns the smallest bucket
upper bound covering the requested rank — a deterministic, order-independent
*guaranteed upper bound* on the true quantile, with relative error bounded by
the bucket ratio (``10^(1/per_decade)``, ~26% at the default 10 buckets per
decade — tight enough to tell 1 ms from 10 ms from 100 ms, which is what a
latency SLO needs).

Pure stdlib on purpose (``bisect`` + lists): the histogram is serialized into
the observability JSONL stream and must round-trip byte-identically.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Dict, List, Mapping

__all__ = ["FixedHistogram", "log_bounds"]


def log_bounds(lo: float, hi: float, per_decade: int = 10) -> tuple:
    """Log-spaced bucket upper bounds from ``lo`` to >= ``hi``.

    Deterministic: bounds are computed as ``lo * 10**(k/per_decade)`` for
    integer ``k``, so two processes building the same (lo, hi, per_decade)
    get bit-identical floats."""
    if lo <= 0 or hi <= lo:
        raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
    out: List[float] = []
    k = 0
    while True:
        b = lo * 10.0 ** (k / per_decade)
        out.append(b)
        if b >= hi:
            break
        k += 1
    return tuple(out)


# default latency range: 10 us .. 100 s, 10 buckets/decade (71 buckets).
_DEFAULT_LATENCY_BOUNDS = log_bounds(1e-5, 100.0, per_decade=10)


@dataclasses.dataclass
class FixedHistogram:
    """Exact-count histogram over fixed ascending bucket upper bounds.

    Bucket ``i`` covers ``(bounds[i-1], bounds[i]]`` (bucket 0 covers
    ``(-inf, bounds[0]]``); ``counts[len(bounds)]`` is the overflow bucket
    for observations past the last bound.  ``min``/``max``/``sum`` are kept
    exactly so the overflow bucket can still report its true maximum.
    """

    bounds: tuple
    counts: List[int] = dataclasses.field(default_factory=list)
    count: int = 0
    sum: float = 0.0
    min: float = 0.0
    max: float = 0.0

    def __post_init__(self):
        self.bounds = tuple(float(b) for b in self.bounds)
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError("bounds must be strictly ascending")
        if not self.counts:
            self.counts = [0] * (len(self.bounds) + 1)
        elif len(self.counts) != len(self.bounds) + 1:
            raise ValueError(
                f"counts must have len(bounds)+1 = {len(self.bounds) + 1} "
                f"entries, got {len(self.counts)}"
            )

    @classmethod
    def latency(cls) -> "FixedHistogram":
        """The canonical latency histogram (seconds, 10 us .. 100 s)."""
        return cls(bounds=_DEFAULT_LATENCY_BOUNDS)

    def observe(self, x: float) -> None:
        x = float(x)
        i = bisect.bisect_left(self.bounds, x)  # first bound >= x; overflow past end
        self.counts[i] += 1
        if self.count == 0:
            self.min = self.max = x
        else:
            self.min = min(self.min, x)
            self.max = max(self.max, x)
        self.count += 1
        self.sum += x

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Deterministic upper bound on the ``q``-quantile (q in [0, 1]).

        Returns the upper bound of the bucket containing the
        ``ceil(q * count)``-th smallest observation — the true quantile is
        <= the returned value and > the bucket's lower edge.  The overflow
        bucket reports the exact observed maximum.  0.0 when empty."""
        if self.count == 0:
            return 0.0
        # ceil(q * count), nudged so binary-inexact q (0.999 * 1000 ->
        # 999.0000000000001) does not round the rank up a whole sample
        rank = max(1, min(self.count, math.ceil(q * self.count - 1e-9)))
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= rank:
                if i >= len(self.bounds):  # overflow bucket
                    return self.max
                # never report past the observed max (single-sample exactness)
                return min(self.bounds[i], self.max)
        return self.max

    def percentiles(self) -> Dict[str, float]:
        return {
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
            "p999": self.quantile(0.999),
        }

    def merge(self, other: "FixedHistogram") -> "FixedHistogram":
        """Exact merge of two histograms over identical bounds (shard/replica
        aggregation) — counts add, extrema combine."""
        if self.bounds != other.bounds:
            raise ValueError("cannot merge histograms with different bounds")
        out = FixedHistogram(
            bounds=self.bounds,
            counts=[a + b for a, b in zip(self.counts, other.counts)],
            count=self.count + other.count,
            sum=self.sum + other.sum,
        )
        if self.count and other.count:
            out.min, out.max = min(self.min, other.min), max(self.max, other.max)
        elif self.count:
            out.min, out.max = self.min, self.max
        else:
            out.min, out.max = other.min, other.max
        return out

    def to_dict(self) -> Dict[str, object]:
        return {
            "bounds": list(self.bounds),
            "counts": list(self.counts),
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, object]) -> "FixedHistogram":
        return cls(
            bounds=tuple(d["bounds"]),
            counts=list(d["counts"]),
            count=int(d["count"]),
            sum=float(d["sum"]),
            min=float(d["min"]),
            max=float(d["max"]),
        )
