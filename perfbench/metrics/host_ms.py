"""host_ms: per batch, the harness's span around `query_batch` less the
service's own precompute_s and solve_s: the host path around the device
work (validation, select and pad, guards), mean over the window."""


def read(m):
    b = m.get("batches")
    if not b:
        return None
    return sum((r["t1"] - r["t0"]) - r["precompute_s"] - r["solve_s"]
               for r in b) / len(b) * 1e3
