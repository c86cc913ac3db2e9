"""Observability layer (port of ``repro.obs``): exact counters, spans,
deterministic latency histograms."""
from repro_torch.obs.hist import FixedHistogram, log_bounds
from repro_torch.obs.hub import ExactCounter, MetricsHub
from repro_torch.obs.tracing import NULL_TRACER, Tracer

__all__ = [
    "ExactCounter",
    "FixedHistogram",
    "MetricsHub",
    "NULL_TRACER",
    "Tracer",
    "log_bounds",
]
