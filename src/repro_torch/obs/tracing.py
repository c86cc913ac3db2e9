"""Host-side span tracing (port of ``repro.obs.tracing``).

The pipelined trainer's whole value proposition is *overlap* — plan t+1
dispatched under compute t — and BagPipe's lesson (arXiv 2202.12429) is that
those wins are only real if you can see which stage hides which latency.
``Tracer`` records named wall-clock spans at the stage boundaries the Python
loop actually controls (plan / compute / apply / refresh / host-transfer /
checkpoint / score) and exports them as Chrome-trace JSON, so a run renders
directly in ``chrome://tracing`` / Perfetto with one row per thread and the
group structure visible.

Two caveats, by design:

* CUDA launches are asynchronous — a span around device work measures
  *dispatch* time unless something blocks inside it (the serve engine's
  response copy to the host does), so the span profile shows where the
  Python loop spends wall-clock.
* device-side timing needs the real profiler: with ``annotate=True`` every
  span also enters a ``torch.profiler.record_function``, so the same stage
  names appear on the device timeline of a ``torch.profiler`` capture.

Raw events are capped (``max_events``, default 100k) so a week-long serve
loop cannot grow without bound — aggregate stats (count / total per name)
stay exact past the cap.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, List

__all__ = ["Tracer", "NULL_TRACER"]


class Tracer:
    """Named wall-clock spans with Chrome-trace export.

    Thread-safe: the serve engine's replica workers and the trainer's
    prefetch thread may all record spans; events carry the recording
    thread's id so the Chrome trace renders one row per thread.
    """

    def __init__(self, annotate: bool = False, max_events: int = 100_000):
        self.annotate = annotate
        self.max_events = max_events
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._dropped = 0
        # exact aggregates, never capped: name -> [count, total_seconds]
        self._agg: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def span(self, name: str, **attrs: Any):
        """Record one ``name`` span around the body (optionally annotating
        the profiler timeline via ``torch.profiler.record_function``)."""
        ann = contextlib.nullcontext()
        if self.annotate:
            import torch.profiler

            ann = torch.profiler.record_function(name)
        start = time.perf_counter()
        with ann:
            try:
                yield
            finally:
                dur = time.perf_counter() - start
                self._record(name, start - self._t0, dur, attrs)

    def _record(self, name: str, ts: float, dur: float, attrs: Dict) -> None:
        with self._lock:
            agg = self._agg.setdefault(name, [0, 0.0])
            agg[0] += 1
            agg[1] += dur
            if len(self._events) >= self.max_events:
                self._dropped += 1
                return
            ev = {"name": name, "ts": ts, "dur": dur,
                  "tid": threading.get_ident()}
            if attrs:
                ev["args"] = dict(attrs)
            self._events.append(ev)

    # -- aggregates ----------------------------------------------------------

    def stage_summary(self) -> Dict[str, Dict[str, float]]:
        """Exact per-stage aggregates: ``{name: {count, total_s, mean_ms}}``
        (counts survive the raw-event cap)."""
        with self._lock:
            return {
                name: {
                    "count": int(c),
                    "total_s": t,
                    "mean_ms": 1e3 * t / c if c else 0.0,
                }
                for name, (c, t) in sorted(self._agg.items())
            }

    @property
    def dropped_events(self) -> int:
        return self._dropped

    # -- export --------------------------------------------------------------

    def chrome_trace(self) -> Dict[str, Any]:
        """Chrome-trace/Perfetto JSON object (``ph: "X"`` complete events,
        microsecond timestamps relative to tracer start)."""
        with self._lock:
            events = [
                {
                    "name": ev["name"],
                    "ph": "X",
                    "ts": round(ev["ts"] * 1e6, 3),
                    "dur": round(ev["dur"] * 1e6, 3),
                    "pid": os.getpid(),
                    "tid": ev["tid"],
                    **({"args": ev["args"]} if "args" in ev else {}),
                }
                for ev in self._events
            ]
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str) -> str:
        """Write the Chrome-trace JSON to ``path`` (atomic rename so a
        crashed run never leaves a half-written trace); returns the path."""
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(self.chrome_trace(), f)
        os.replace(tmp, path)
        return path


class _NullTracer(Tracer):
    """Zero-overhead stand-in when observability is off: ``span`` returns a
    shared nullcontext, records nothing."""

    def __init__(self):
        super().__init__(annotate=False, max_events=0)
        self._null = contextlib.nullcontext()

    def span(self, name: str, **attrs: Any):  # noqa: ARG002 - interface parity
        return self._null


NULL_TRACER: Tracer = _NullTracer()
