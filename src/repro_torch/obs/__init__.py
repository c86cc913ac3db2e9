"""Observability layer (port of ``repro.obs``): exact counters, gauges,
spans, deterministic latency histograms; ``python -m
repro_torch.obs.report <run.jsonl>`` renders a run."""
from repro_torch.obs.hist import FixedHistogram, log_bounds
from repro_torch.obs.hub import ExactCounter, Gauge, MetricsHub
from repro_torch.obs.tracing import NULL_TRACER, Tracer

__all__ = [
    "ExactCounter",
    "FixedHistogram",
    "Gauge",
    "MetricsHub",
    "NULL_TRACER",
    "Tracer",
    "log_bounds",
]
