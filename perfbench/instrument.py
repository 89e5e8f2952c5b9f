"""Harness spans around the calls into the program's layers, for traced
runs only: each listed entry point of the service and its K cache is
wrapped on the instance, so a traced run records (label, t0, t1) on the
monotonic clock and an untraced run runs the program untouched. An entry
point that a later version of the program no longer has is skipped."""
from __future__ import annotations

import functools
import time

# (attribute of the service, label); "_kcache." entries are on its K cache
SERVICE_SPANS = (
    ("query_batch", "query_batch"),
    ("top_k_batch", "top_k_batch"),
    ("_validate_queries", "host: validate"),
    ("_padded_query_batch", "host: select and pad"),
    ("_kcache.stripes_for_batch", "precompute: K cache"),
    ("_check_km", "host: K*M guard"),
    ("_check_result", "host: distance guard"),
    ("_cascade_bounds", "bound tiers"),
    ("_rerank_per_query", "rerank"),
    ("_top_k", "host: top-k select"),
)


class Spans:
    """Records spans; ``last_solve`` keeps the arguments of the newest call
    of the batch's solve program."""

    def __init__(self):
        self.spans: list[tuple[str, float, float]] = []
        self.last_solve = None

    def wrap(self, fn, label: str):
        rec = self.spans

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            t0 = time.monotonic()
            try:
                return fn(*a, **kw)
            finally:
                rec.append((label, t0, time.monotonic()))
        return wrapper

    def attach(self, svc) -> None:
        for path, label in SERVICE_SPANS:
            owner, _, attr = path.rpartition(".")
            obj = getattr(svc, owner, None) if owner else svc
            fn = getattr(obj, attr, None) if obj is not None else None
            if callable(fn):
                setattr(obj, attr, self.wrap(fn, label))
        make = getattr(svc, "_stripe_fn", None)
        if callable(make):
            spans = self

            def stripe_fn(*a, **kw):
                fn = make(*a, **kw)

                def solve(*args, **kwargs):
                    spans.last_solve = (fn, args, kwargs)
                    t0 = time.monotonic()
                    try:
                        return fn(*args, **kwargs)
                    finally:
                        spans.spans.append(("solve program", t0,
                                            time.monotonic()))
                return solve
            svc._stripe_fn = stripe_fn
