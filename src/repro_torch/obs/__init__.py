"""Observability: the tracer and metrics registry, copied from the JAX
package (stdlib only). The engine's ``tracer``/``metrics`` seam defaults to
the shared no-op :data:`NULL_TRACER` / :data:`NULL_METRICS`."""
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NULL_METRICS,
    nearest_rank,
    time_buckets,
)
from repro_torch.obs.trace import NULL_TRACER, PHASES, Tracer

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_METRICS",
    "NULL_TRACER",
    "PHASES",
    "Tracer",
    "nearest_rank",
    "time_buckets",
]
