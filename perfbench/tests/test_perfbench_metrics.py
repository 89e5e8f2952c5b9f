"""The metric readers' arithmetic and the reading of a device trace."""
import numpy as np
import pytest

import perfbench_tiny  # noqa: F401  (paths)
from perfbench import cells, devtime


def _read(name, m):
    return cells.reader(name)(m)


def _bulk():
    return {"loop": "closed", "setup_s": 12.5, "window_s": 10.0,
            "queries": 640,
            "batches": [{"t0": 0.0, "t1": 0.030, "precompute_s": 0.002,
                         "solve_s": 0.020},
                        {"t0": 1.0, "t1": 1.050, "precompute_s": 0.004,
                         "solve_s": 0.030}],
            "kcache": (90, 10),
            "solve": {"device_s": 0.5, "least_s": 0.01},
            "trace": {"busy_s": 1.5, "window_s": 2.0}}


def test_bulk_readers():
    m = _bulk()
    assert _read("qps", m) == pytest.approx(64.0)
    assert _read("setup_s", m) == 12.5
    assert _read("host_ms", m) == pytest.approx((8 + 16) / 2)
    assert _read("precompute_ms", m) == pytest.approx(3.0)
    assert _read("solve_ms", m) == pytest.approx(25.0)
    assert _read("kcache_hit_rate", m) == pytest.approx(0.9)
    assert _read("solve_roofline", m) == pytest.approx(2.0)
    assert _read("idle_share.bulk", m) == pytest.approx(0.25)
    assert _read("idle_share.serve", m) is None
    assert _read("p95_ms", m) is None


def test_serve_readers():
    lat = np.arange(1, 101, dtype=float) / 1e3       # 1..100 ms
    m = {"loop": "open", "setup_s": 3.0, "latency_s": lat,
         "dispatches": 4, "dispatched": 30,
         "dispatch_spans": [(0.0, 0.2), (1.0, 1.4)],
         "kcache": (0, 0), "trace": {"busy_s": 0.5, "window_s": 2.0}}
    assert _read("p95_ms", m) == pytest.approx(np.percentile(lat, 95) * 1e3)
    assert _read("batch_fill", m) == pytest.approx(7.5)
    assert _read("dispatch_ms.serve", m) == pytest.approx(300.0)
    assert _read("idle_share.serve", m) == pytest.approx(0.75)
    assert _read("qps", m) is None
    assert _read("kcache_hit_rate", m) is None


def test_readers_of_missing_readings_return_nothing():
    m = {"loop": "closed", "kcache": (0, 0)}
    for name in ("solve_roofline", "idle_share.bulk", "host_ms",
                 "precompute_ms", "solve_ms", "dispatch_ms.serve",
                 "batch_fill"):
        assert _read(name, m) is None, name


class _FakeStretch:
    """A traced stretch on ``card_ids``; an event without a card index lies
    on card 0."""

    def __init__(self, t0, t1, events, card_ids=(0,)):
        self.t0, self.t1, self.card_ids = t0, t1, list(card_ids)
        self._events = [e if len(e) == 4 else (*e, 0) for e in events]

    def device_events(self):
        return sorted(self._events, key=lambda e: e[1])


def test_read_stretch_busy_ops_and_gaps():
    evs = [("type1_vm_kernel<1>", 1.0, 2.0),
           ("type1_vm_kernel<1>", 1.5, 2.5),      # overlaps: merged
           ("elementwise", 4.0, 5.0),
           ("Memcpy DtoH", 9.5, 11.0)]            # past the end: cut
    spans = [("query_batch", 0.0, 10.0), ("host: select and pad", 2.5, 4.0),
             ("host: distance guard", 5.0, 9.0)]
    rd = devtime.read_stretch(_FakeStretch(0.0, 10.0, evs), spans,
                              ["type1_vm_kernel", "vocab_major_kernel"])
    assert rd["busy_s"] == pytest.approx(1.5 + 1.0 + 0.5)
    assert rd["window_s"] == 10.0
    assert rd["hand_kernel_events"] == 2
    ops = dict(rd["device_ops"])
    assert ops["type1_vm_kernel<1>"] == pytest.approx(2.0)
    assert ops["Memcpy DtoH"] == pytest.approx(0.5)
    gaps = dict(rd["idle_gaps"])
    assert gaps["query_batch (1 gaps)"] == pytest.approx(1.0)       # 0..1
    assert gaps["host: select and pad (1 gaps)"] == pytest.approx(1.5)
    assert gaps["host: distance guard (1 gaps)"] == pytest.approx(4.5)
    assert sum(s for _, s in rd["idle_gaps"]) == pytest.approx(10 - 3.0)


def test_merge():
    assert devtime.merge([(3, 4), (0, 1), (0.5, 2)]) == [[0, 2], [3, 4]]


def test_kernel_names_of_the_program():
    names = devtime.kernel_names(perfbench_tiny.ROOT / "src" / "repro_torch"
                                 / "kernels" / "csrc")
    for k in ("type1_vm_kernel", "type2_vm_kernel", "vocab_major_kernel",
              "cost_rows_kernel"):
        assert k in names
