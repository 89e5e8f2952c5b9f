"""Per-request span tracing + structured event log for the serving stack.

A stdlib copy of `repro.obs.trace`.

A :class:`Tracer` collects, per submitted request, a small span tree --
root ``request`` span (submit -> fan-out) with children for queue wait,
the dispatch itself, and the engine phases the service can attribute
(K-cache precompute, solve, RWMD bound, rerank).  Completed trees land
in a bounded ring buffer; alongside them a structured event log records
the one-shot facts an operator reasons about in the resilience runbook:
breaker transitions, brownout enter/exit, watchdog strikes, quarantines,
``DegradedResult`` reasons, WAL append / compaction boundaries.

Exports:

- :meth:`Tracer.chrome_trace` / :meth:`Tracer.export_chrome` -- Chrome
  trace-event JSON (``ph: "X"`` complete events, ``ph: "i"`` instants),
  loadable directly in Perfetto / ``chrome://tracing``.
- :meth:`Tracer.export_events_jsonl` / :meth:`Tracer.drain_events` --
  the event log as JSON-lines (one dict per line), for live tailing.

Contract (the whole point of the design):

- **Off = free.**  The shared :data:`NULL_TRACER` is the default
  everywhere; its methods are no-ops and ``enabled`` is ``False`` so
  hot paths can skip even building the attrs dict.
- **Never touches arrays.**  Spans carry only scalars pulled from stats
  dicts; attaching a tracer is bitwise-neutral on every engine route
  (pinned in ``tests/test_torch_obs_trace.py``).
- **Every request closes exactly once.**  Quarantined, cancelled,
  failed and degraded requests all end as closed trees with a status --
  the chaos suite asserts submitted == closed with no leaks.

stdlib-only; safe to import from any layer.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Callable

__all__ = ["Tracer", "NullTracer", "NULL_TRACER"]


class NullTracer:
    """Shared no-op recorder: observability off, zero hot-path cost."""

    enabled = False

    def begin_request(self, seq, **attrs):
        pass

    def add_span(self, seq, name, t0, t1, **attrs):
        pass

    def end_request(self, seq, t1=None, status="ok", **attrs):
        pass

    def closed_request(self, *, status, t0=None, t1=None, **attrs):
        pass

    def event(self, name, **fields):
        pass


NULL_TRACER = NullTracer()


class Tracer(NullTracer):
    """Span/event recorder with bounded memory.

    ``ring``/``max_events`` bound the two deques; one request tree is a
    handful of small dicts, so the defaults hold thousands of requests
    in a few MB.  All methods are thread-safe (client threads submit,
    the dispatcher thread closes) and never raise into the caller.
    """

    enabled = True

    def __init__(self, *, ring: int = 4096, max_events: int = 65536,
                 clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._open: dict[object, dict] = {}
        self.completed: deque[dict] = deque(maxlen=ring)
        self.events: deque[dict] = deque(maxlen=max_events)
        self._anon = 0          # ids for trees closed without a seq
        self._dropped = 0       # trees evicted from the ring

    def now(self) -> float:
        return self._clock()

    # ---------------------------------------------------------- spans

    def begin_request(self, seq, **attrs):
        t0 = attrs.pop("t0", None)
        tree = {"seq": seq, "t0": self._clock() if t0 is None else t0,
                "t1": None, "status": None, "attrs": attrs, "spans": []}
        with self._lock:
            # a seq reused before closure would leak its first tree;
            # close it defensively rather than lose it
            prev = self._open.pop(seq, None)
            if prev is not None:
                prev["t1"] = tree["t0"]
                prev["status"] = "orphaned"
                self._finish_locked(prev)
            self._open[seq] = tree

    def add_span(self, seq, name, t0, t1, **attrs):
        with self._lock:
            tree = self._open.get(seq)
            if tree is None:
                return
            tree["spans"].append(
                {"name": name, "t0": t0, "t1": t1, "attrs": attrs})

    def end_request(self, seq, t1=None, status="ok", **attrs):
        t1 = self._clock() if t1 is None else t1
        with self._lock:
            tree = self._open.pop(seq, None)
            if tree is None:
                return
            tree["t1"] = t1
            tree["status"] = status
            if attrs:
                tree["attrs"].update(attrs)
            self._finish_locked(tree)

    def closed_request(self, *, status, t0=None, t1=None, **attrs):
        """Record an already-finished request as a closed single-node
        tree (e.g. quarantined at submit: never enqueued, never open)."""
        t = self._clock()
        tree = {"seq": None, "t0": t if t0 is None else t0,
                "t1": t if t1 is None else t1, "status": status,
                "attrs": attrs, "spans": []}
        with self._lock:
            self._anon += 1
            tree["seq"] = f"anon-{self._anon}"
            self._finish_locked(tree)

    def _finish_locked(self, tree: dict) -> None:
        if len(self.completed) == self.completed.maxlen:
            self._dropped += 1
        self.completed.append(tree)

    # ---------------------------------------------------------- events

    def event(self, name, **fields):
        ev = {"t": self._clock(), "event": name}
        ev.update(fields)
        with self._lock:
            self.events.append(ev)

    def drain_events(self) -> list[dict]:
        """Return and clear the buffered events (for periodic flush)."""
        with self._lock:
            out = list(self.events)
            self.events.clear()
        return out

    # ---------------------------------------------------------- state

    @property
    def open_count(self) -> int:
        with self._lock:
            return len(self._open)

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def snapshot(self) -> tuple[list[dict], list[dict]]:
        """(completed trees, events) as lists -- no clearing."""
        with self._lock:
            return list(self.completed), list(self.events)

    # ---------------------------------------------------------- export

    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON object (Perfetto-loadable).

        Layout: each request tree gets its own ``tid`` (its row in the
        viewer) under ``pid`` 1, with the root span and its phase
        children as ``"X"`` complete events; log events appear as
        ``"i"`` instants on tid 0.  Timestamps are microseconds from
        the tracer's clock origin.
        """
        trees, events = self.snapshot()
        tids = {t["seq"]: i + 1 for i, t in enumerate(trees)}
        tev: list[dict] = []

        def us(t: float) -> float:
            return t * 1e6

        def x(name, t0, t1, tid, args):
            tev.append({
                "name": name, "ph": "X", "pid": 1, "tid": tid,
                "ts": us(t0), "dur": max(us(t1) - us(t0), 0.0),
                "cat": "wmd", "args": args,
            })

        for tree in trees:
            tid = tids[tree["seq"]]
            args = {"seq": str(tree["seq"]), "status": tree["status"]}
            args.update(_jsonable(tree["attrs"]))
            x(f"request[{tree['status']}]", tree["t0"],
              tree["t1"] if tree["t1"] is not None else tree["t0"],
              tid, args)
            for sp in tree["spans"]:
                x(sp["name"], sp["t0"], sp["t1"], tid,
                  _jsonable(sp["attrs"]))
        for ev in events:
            args = {k: v for k, v in ev.items() if k not in ("t", "event")}
            tev.append({
                "name": ev["event"], "ph": "i", "pid": 1, "tid": 0,
                "ts": us(ev["t"]), "s": "g", "cat": "wmd-event",
                "args": _jsonable(args),
            })
        return {"traceEvents": tev, "displayTimeUnit": "ms"}

    def export_chrome(self, path: str) -> int:
        """Write the Chrome trace JSON; returns the event count."""
        obj = self.chrome_trace()
        with open(path, "w") as f:
            json.dump(obj, f)
        return len(obj["traceEvents"])

    def export_events_jsonl(self, path: str, *, append: bool = False) -> int:
        """Write the event log as JSON-lines; returns the line count."""
        _, events = self.snapshot()
        with open(path, "a" if append else "w") as f:
            for ev in events:
                f.write(json.dumps(_jsonable(ev)) + "\n")
        return len(events)


def _jsonable(obj):
    """Best-effort plain-data coercion (numpy scalars -> python floats,
    everything unknown -> repr) so export never raises."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    item = getattr(obj, "item", None)   # numpy scalar
    if callable(item):
        try:
            return _jsonable(item())
        except Exception:
            pass
    return repr(obj)
