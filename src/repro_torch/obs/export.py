"""Export surfaces for the observability layer.

A stdlib copy of `repro.obs.export`.

- :func:`render_prometheus` -- a :class:`~repro_torch.obs.metrics.MetricsRegistry`
  to Prometheus text exposition format (version 0.0.4): ``# HELP`` /
  ``# TYPE`` per metric name, cumulative ``_bucket{le=...}`` series plus
  ``_sum``/``_count`` for histograms.
- :class:`MetricsServer` -- a stdlib ``http.server`` daemon thread
  serving ``GET /metrics`` so a running serve loop can be scraped live
  (``launch.serve --metrics-port``).
- :class:`JsonlExporter` -- periodic flush of a tracer's event log to a
  JSON-lines file (append-only; survives the process dying between
  flushes up to one period of loss).

stdlib-only, same as the rest of ``repro_torch.obs``.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.trace import Tracer, _jsonable

__all__ = ["render_prometheus", "MetricsServer", "JsonlExporter"]

_ESC = str.maketrans({"\\": r"\\", "\n": r"\n", '"': r'\"'})


def _fmt_labels(labels: dict[str, str], extra: dict[str, str] | None = None
                ) -> str:
    items = dict(labels)
    if extra:
        items.update(extra)
    if not items:
        return ""
    inner = ",".join(f'{k}="{str(v).translate(_ESC)}"'
                     for k, v in sorted(items.items()))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f.is_integer() else repr(f)


def render_prometheus(registry: MetricsRegistry) -> str:
    """Render every metric in the registry as text exposition format."""
    lines: list[str] = []
    seen_header: set[str] = set()
    for m in registry.collect():
        if m.name not in seen_header:
            seen_header.add(m.name)
            if m.help:
                lines.append(f"# HELP {m.name} {m.help.translate(_ESC)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
        if isinstance(m, (Counter, Gauge)):
            lines.append(
                f"{m.name}{_fmt_labels(m.labels)} {_fmt_value(m.value)}")
        elif isinstance(m, Histogram):
            for le, c in m.cumulative():
                lab = _fmt_labels(m.labels, {"le": _fmt_value(le)})
                lines.append(f"{m.name}_bucket{lab} {c}")
            lines.append(
                f"{m.name}_sum{_fmt_labels(m.labels)} {_fmt_value(m.sum)}")
            lines.append(
                f"{m.name}_count{_fmt_labels(m.labels)} {m.count}")
    return "\n".join(lines) + "\n"


class MetricsServer:
    """Prometheus scrape endpoint on a daemon thread.

    ``GET /metrics`` renders the registry; ``GET /healthz`` answers
    ``ok`` (a liveness probe that costs nothing).  ``port=0`` binds an
    ephemeral port -- read it back from ``.port`` (tests do).
    """

    def __init__(self, registry: MetricsRegistry, port: int = 0,
                 host: str = "0.0.0.0"):
        self.registry = registry
        srv = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):                          # noqa: N802
                if self.path.split("?")[0] == "/metrics":
                    body = render_prometheus(srv.registry).encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif self.path.split("?")[0] == "/healthz":
                    body, ctype = b"ok\n", "text/plain"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):                 # scrapes are chatty
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="wmd-metrics",
            daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class JsonlExporter:
    """Flush a tracer's event log to a JSONL file every ``interval_s``.

    Events are *drained* (removed from the tracer's ring) on each flush,
    so long runs never lose old events to ring eviction; ``close()``
    performs a final flush.  The file is append-mode: one process run ==
    one growing log.
    """

    def __init__(self, tracer: Tracer, path: str, interval_s: float = 1.0):
        self.tracer = tracer
        self.path = path
        self.interval_s = interval_s
        self.written = 0
        open(path, "w").close()                        # truncate at start
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="wmd-trace-flush", daemon=True)
        self._thread.start()

    def _flush(self) -> None:
        events = self.tracer.drain_events()
        if not events:
            return
        with open(self.path, "a") as f:
            for ev in events:
                f.write(json.dumps(_jsonable(ev)) + "\n")
        self.written += len(events)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self._flush()
            except Exception:
                pass            # exporter must never kill the process

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
