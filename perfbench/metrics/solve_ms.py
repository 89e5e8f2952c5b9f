"""solve_ms: the service's last_batch_stats solve_s (the stripes program
and the distances' copy to the host), mean per batch over the window."""


def read(m):
    b = m.get("batches")
    if not b:
        return None
    return sum(r["solve_s"] for r in b) / len(b) * 1e3
