"""p95_ms: the 95th percentile of the latency of the window's requests,
each timed from when it was due until its future resolved."""
import numpy as np


def read(m):
    lat = m.get("latency_s")
    if lat is None or lat.size == 0:
        return None
    return float(np.percentile(lat, 95) * 1e3)
