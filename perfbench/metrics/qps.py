"""qps: every query answered in the window over the window's seconds (a
closed loop's window ends when its last batch returns)."""


def read(m):
    if m["loop"] != "closed":
        return None
    return m["queries"] / m["window_s"]
