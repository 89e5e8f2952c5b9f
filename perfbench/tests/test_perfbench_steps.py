"""`perfbench/steps.py`: the step readings from the service's span trees,
gaps labelled by the program's spans with `devtime.read_stretch`'s rule,
the solve spans' cover of #3's events, and one tiny run on the CPU."""
import pytest

import perfbench_tiny
from perfbench import devtime, steps
from test_perfbench_metrics import _FakeStretch


def _tree(seq, t0, t1, spans, op="query_batch", status="ok"):
    return {"seq": seq, "t0": t0, "t1": t1, "status": status,
            "attrs": {"op": op, "q": 64, "q_pad": 64, "route": "stripes"},
            "spans": [{"name": n, "t0": a, "t1": b, "attrs": {}}
                      for n, a, b in spans]}


TREES = [
    _tree("batch-1", 0.0, 0.040, [("validate", 0.000, 0.010),
                                  ("select_pad", 0.010, 0.014),
                                  ("kcache", 0.014, 0.020),
                                  ("km_guard", 0.020, 0.021),
                                  ("solve", 0.021, 0.034),
                                  ("d2h", 0.034, 0.035),
                                  ("distance_guard", 0.036, 0.039)]),
    _tree("batch-2", 1.0, 1.030, [("validate", 1.000, 1.008),
                                  ("select_pad", 1.008, 1.010),
                                  ("km_guard", 1.010, 1.011),
                                  ("solve", 1.011, 1.020),
                                  ("d2h", 1.020, 1.024),
                                  ("distance_guard", 1.024, 1.026)]),
    _tree("batch-3", 2.0, 2.5, [("validate", 2.0, 2.1)],
          status="failed"),                             # not a batch
    _tree("batch-4", 3.0, 3.5, [("host_topk", 3.0, 3.1)],
          op="top_k_batch"),                            # another op
]


def test_batch_steps_and_the_five_readings():
    per = steps.batch_steps(TREES)
    assert len(per) == 2
    assert per[0]["batch"] == pytest.approx(0.040)
    assert per[0]["other"] == pytest.approx(0.040 - 0.038)
    assert per[1]["other"] == pytest.approx(0.030 - 0.026)
    rd = steps.readings(per)
    assert rd["validate_ms"] == pytest.approx((10 + 8) / 2)
    assert rd["select_pad_ms"] == pytest.approx((4 + 2) / 2)
    assert rd["guard_ms"] == pytest.approx((1 + 3 + 1 + 2) / 2)
    assert rd["d2h_ms"] == pytest.approx((1 + 4) / 2)
    assert rd["batch_other_ms"] == pytest.approx((2 + 4) / 2)
    assert rd["batch_ms"] == pytest.approx(35.0)
    assert steps.step_means(per)["kcache"] == pytest.approx(3.0)
    assert steps.readings([]) == {}


def test_overlapping_steps_are_not_counted_twice_as_covered():
    t = _tree("batch-9", 0.0, 1.0, [("a", 0.0, 0.6), ("b", 0.4, 0.8)])
    (rec,) = steps.batch_steps([t])
    assert rec["other"] == pytest.approx(0.2)


def test_labels_follow_read_stretch():
    """`steps.label` sums to `devtime.read_stretch`'s gaps on the harness's
    spans, and the program's spans put the same gaps in steps."""
    evs = [("vocab_major_kernel", 0.015, 0.019),
           ("type1_vm_kernel<1>", 0.022, 0.033),
           ("elementwise", 0.0345, 0.0349),
           ("elementwise", 0.0361, 0.037),
           ("cost_rows_kernel", 0.9, 1.0),
           ("type1_vm_kernel<1>", 1.012, 1.019),
           ("elementwise", 1.0245, 1.0255)]
    st = _FakeStretch(0.0, 1.1, evs)
    harness = [("query_batch", 0.0, 0.040), ("host: validate", 0.0, 0.010),
               ("host: select and pad", 0.010, 0.014),
               ("host: distance guard", 0.036, 0.039),
               ("query_batch", 1.0, 1.030), ("host: validate", 1.0, 1.008)]
    rd = devtime.read_stretch(st, harness, ["type1_vm_kernel"])
    gaps = steps.idle_gaps(st)
    got = {}
    for (a, b), lab in zip(gaps, steps.label(gaps, harness)):
        got[lab] = got.get(lab, 0.0) + b - a
    want = {lab.rsplit(" (", 1)[0]: s for lab, s in rd["idle_gaps"]}
    assert got == pytest.approx(want)
    prog = steps.program_spans(TREES[:2])
    table = steps.gap_table(gaps, harness, prog)
    by = {(h, p): s for h, p, s in table["by_label"]}
    assert by[("host: validate", "validate")] == pytest.approx(0.027)
    assert by[("query_batch", "km_guard")] == pytest.approx(0.003)
    assert by[("query_batch", "solve")] == pytest.approx(0.0015)
    assert by[("query_batch", "d2h")] == pytest.approx(0.0055)
    assert by[("query_batch", "query_batch (root)")] == pytest.approx(0.0012)
    assert table["host_idle_s"] == pytest.approx(0.0382)
    assert table["host_idle_in_steps_s"] == pytest.approx(0.0382 - 0.0012)


def test_solve_cover_counts_type1_events_inside_solve_spans():
    evs = [("type1_vm_kernel<1>", 0.022, 0.033),
           ("type1_vm_kernel<1>", 1.012, 1.019),
           ("type1_vm_kernel<1>", 1.019, 1.021),     # ends past its solve
           ("type2_vm_kernel<1>", 0.033, 0.034),
           ("type1_vm_kernel<1>", 1.5, 1.6)]
    assert steps.solve_cover([(*e, 0) for e in evs], TREES) == (2, 4)


def test_record_cost_is_measured():
    assert 0.0 < steps.record_cost_us(50) < 10_000.0


def test_a_tiny_run_on_the_cpu_reads_its_steps():
    c = perfbench_tiny.tiny("paper_5k.bulk_q64")
    res = steps.run_one(c, seed=2 ** 31 + 77, seconds=0.6, trace=True,
                        tracer=True, device="cpu")
    assert res["correct"] and res["tracer"]
    st = res["steps"]
    assert st["batches"] >= 1 and st["dropped"] == 0
    rd = st["readings"]
    assert set(rd) == {"validate_ms", "select_pad_ms", "guard_ms", "d2h_ms",
                       "batch_other_ms", "batch_ms"}
    assert 0.0 <= rd["batch_other_ms"] < rd["batch_ms"]
    assert {"kcache", "solve"} <= set(st["step_ms"])
    untraced = steps.run_one(c, seed=2 ** 31 + 77, seconds=0.6, trace=False,
                             tracer=False, device="cpu")
    assert "steps" not in untraced and untraced["correct"]
