"""idle_share.serve: 1 - device busy / wall over the traced stretch of an
open-loop window (torch.profiler's device events, merged)."""


def read(m):
    t = m.get("trace")
    if m["loop"] != "open" or not t or t["window_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
