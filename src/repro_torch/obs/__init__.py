"""Stdlib serving telemetry.

Re-exports the public names of `repro.obs`, in the reference's order:

- `repro_torch.obs.metrics` -- thread-safe counter/gauge/histogram
  registry, the backing store of ``ServingStats`` and the K-cache stats;
- `repro_torch.obs.trace` -- per-request span trees + structured event
  log, exportable as Chrome trace-event JSON (Perfetto) and JSONL;
- `repro_torch.obs.export` -- Prometheus text exposition, a stdlib HTTP
  scrape endpoint, and a periodic JSONL event flusher.

Recorders never touch tensors or arrays, and observability-off is the
shared `NULL_TRACER` no-op.
"""
from repro_torch.obs.export import (JsonlExporter, MetricsServer,
                                    render_prometheus)
from repro_torch.obs.metrics import (DEFAULT_SIZE_BUCKETS,
                                     DEFAULT_TIME_BUCKETS, Counter, Gauge,
                                     Histogram, MetricsRegistry)
from repro_torch.obs.trace import NULL_TRACER, NullTracer, Tracer

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "DEFAULT_TIME_BUCKETS",
    "DEFAULT_SIZE_BUCKETS",
    "Tracer",
    "NullTracer",
    "NULL_TRACER",
    "render_prometheus",
    "MetricsServer",
    "JsonlExporter",
]
