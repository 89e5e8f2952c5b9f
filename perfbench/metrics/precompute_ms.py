"""precompute_ms: the service's last_batch_stats precompute_s (K cache
lookups, miss rows by kernel #6, the stripes' gather), mean per batch over
the window."""


def read(m):
    b = m.get("batches")
    if not b:
        return None
    return sum(r["precompute_s"] for r in b) / len(b) * 1e3
