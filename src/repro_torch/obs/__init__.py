"""Stdlib serving telemetry.

Re-exports the public names of `repro.obs` that the port has, in the
reference's order. Not ported yet: `trace` (`Tracer`, `NullTracer`,
`NULL_TRACER`) and `export` (`render_prometheus`, `MetricsServer`,
`JsonlExporter`; both ROADMAP Queue 1 item 1).
"""
from repro_torch.obs.metrics import (DEFAULT_SIZE_BUCKETS,
                                     DEFAULT_TIME_BUCKETS, Counter, Gauge,
                                     Histogram, MetricsRegistry)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "DEFAULT_TIME_BUCKETS",
    "DEFAULT_SIZE_BUCKETS",
]
