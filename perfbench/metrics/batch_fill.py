"""batch_fill: queries the coalescer dispatched over the window, per
dispatch (its ServingStats batch-size histogram)."""


def read(m):
    if not m.get("dispatches"):
        return None
    return m["dispatched"] / m["dispatches"]
