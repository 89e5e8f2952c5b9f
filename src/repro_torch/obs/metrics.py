"""Thread-safe counter/gauge/histogram registry: the single backing store
for serving telemetry.

A stdlib copy of `repro.obs.metrics`; the port's service mirrors its K-cache
counters (``wmd_kcache_*``) into it exactly as the reference does.

Design constraints, in order:

- **Dependency-free.** stdlib only; importable from `core/` without
  dragging torch or anything else in.
- **Thread-safe by contract.** Every mutation takes the metric's own
  lock, so counters may be bumped from several threads.
- **Prometheus-shaped.** Metric names follow the exposition conventions
  (``*_total`` counters, ``*_seconds`` units, optional labels).

Metrics never hold tensors and never touch engine inputs/outputs --
attaching a registry is bitwise-neutral on every route.
"""
from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Iterable

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "DEFAULT_TIME_BUCKETS",
    "DEFAULT_SIZE_BUCKETS",
]

# latency-ish seconds buckets (sub-ms batches up to multi-second stalls)
DEFAULT_TIME_BUCKETS: tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)
# pow2 size buckets (batch sizes, row counts)
DEFAULT_SIZE_BUCKETS: tuple[float, ...] = (
    1, 2, 4, 8, 16, 32, 64, 128, 256,
)


def _label_key(labels: dict[str, str] | None) -> tuple[tuple[str, str], ...]:
    if not labels:
        return ()
    return tuple(sorted(labels.items()))


class _Metric:
    """Shared bits: name, help text, frozen label set, own lock."""

    kind = "untyped"

    def __init__(self, name: str, help_: str = "",
                 labels: dict[str, str] | None = None):
        self.name = name
        self.help = help_
        self.labels: dict[str, str] = dict(labels or {})
        self._lock = threading.Lock()


class Counter(_Metric):
    """Monotonic counter. ``inc`` only; never goes down."""

    kind = "counter"

    def __init__(self, name: str, help_: str = "",
                 labels: dict[str, str] | None = None):
        super().__init__(name, help_, labels)
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge(_Metric):
    """Point-in-time value; settable and incrementable either way."""

    kind = "gauge"

    def __init__(self, name: str, help_: str = "",
                 labels: dict[str, str] | None = None):
        super().__init__(name, help_, labels)
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram(_Metric):
    """Fixed-bucket histogram with cumulative Prometheus semantics.

    ``observe(v)`` adds to every bucket whose upper bound ``le >= v``
    at render time; internally we store per-bucket (non-cumulative)
    counts and cumulate when snapshotting, so observe is O(log buckets).
    """

    kind = "histogram"

    def __init__(self, name: str, help_: str = "",
                 buckets: Iterable[float] = DEFAULT_TIME_BUCKETS,
                 labels: dict[str, str] | None = None):
        super().__init__(name, help_, labels)
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError("histogram needs at least one bucket bound")
        self.bounds: tuple[float, ...] = tuple(bs)
        # one extra slot for the +Inf overflow bucket
        self._counts = [0] * (len(bs) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def cumulative(self) -> list[tuple[float, int]]:
        """``[(le, cumulative_count), ...]`` ending with ``(inf, count)``."""
        with self._lock:
            counts = list(self._counts)
        out, run = [], 0
        for le, c in zip(self.bounds, counts):
            run += c
            out.append((le, run))
        out.append((float("inf"), run + counts[-1]))
        return out


class MetricsRegistry:
    """Get-or-create registry keyed by (name, labels).

    Re-registering an existing (name, labels) pair returns the same
    object; re-registering under a different metric kind raises -- a
    name means one thing for the process's lifetime.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[tuple, _Metric] = {}

    def _get_or_create(self, cls, name: str, help_: str,
                       labels: dict[str, str] | None, **kw) -> _Metric:
        key = (name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is not None:
                if not isinstance(m, cls):
                    raise TypeError(
                        f"metric {name!r} already registered as {m.kind}, "
                        f"not {cls.kind}")
                return m
            m = cls(name, help_, labels=labels, **kw)
            self._metrics[key] = m
            return m

    def counter(self, name: str, help_: str = "",
                labels: dict[str, str] | None = None) -> Counter:
        return self._get_or_create(Counter, name, help_, labels)

    def gauge(self, name: str, help_: str = "",
              labels: dict[str, str] | None = None) -> Gauge:
        return self._get_or_create(Gauge, name, help_, labels)

    def histogram(self, name: str, help_: str = "",
                  buckets: Iterable[float] = DEFAULT_TIME_BUCKETS,
                  labels: dict[str, str] | None = None) -> Histogram:
        return self._get_or_create(Histogram, name, help_, labels,
                                   buckets=buckets)

    def collect(self) -> list[_Metric]:
        """All metrics, grouped by name (stable order within a name)."""
        with self._lock:
            ms = list(self._metrics.values())
        ms.sort(key=lambda m: (m.name, _label_key(m.labels)))
        return ms

    def snapshot(self) -> dict[str, object]:
        """Plain-data dump (JSON-able) of every metric's current value."""
        out: dict[str, object] = {}
        for m in self.collect():
            key = m.name
            if m.labels:
                lbl = ",".join(f"{k}={v}" for k, v in sorted(m.labels.items()))
                key = f"{m.name}{{{lbl}}}"
            if isinstance(m, Histogram):
                out[key] = {
                    "count": m.count,
                    "sum": m.sum,
                    # stringify the +Inf bound: strict-JSON consumers choke
                    # on bare Infinity literals
                    "buckets": [["+Inf" if le == float("inf") else le, c]
                                for le, c in m.cumulative()],
                }
            else:
                out[key] = m.value  # type: ignore[union-attr]
        return out
