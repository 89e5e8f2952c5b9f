"""dispatch_ms.serve: the mean wall time of a coalescer dispatch over the
window, from the Tracer's dispatch spans (one per dispatch)."""


def read(m):
    spans = m.get("dispatch_spans")
    if not spans:
        return None
    return sum(t1 - t0 for t0, t1 in spans) / len(spans) * 1e3
