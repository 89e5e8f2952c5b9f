"""A cell laid out on a mesh of its cards: the cell file's ``mesh`` is
checked against the cell's chips, a (4, 1) mesh of logical shards on the
CPU answers bitwise as the 1 x 1 layout, and the per-card readings of
`devtime` and `work` reduce to the one-card formulas on one card."""
import numpy as np
import pytest
import torch

import perfbench_tiny
from perfbench import cells, corpus, devtime, run, work
from repro_torch.core.distributed import _doc_bounds
from test_perfbench_metrics import _FakeStretch

CELL = "prod_5m_shard4.bulk_q16"
MESH_41 = {"shape": [4, 1], "axes": ["data", "model"]}


def _load(monkeypatch, mesh, chips):
    """`cells.load` of CELL with its cell file given ``mesh`` (None: no
    key) and its BENCHMARK.json entry ``chips``."""
    bench = cells.benchmark()
    for w in bench["workloads"]:
        if w["name"] == CELL:
            w["chips"] = chips
    read = cells._load_json

    def load_json(kind, name):
        d = read(kind, name)
        if kind == "workloads" and mesh is not None:
            d["mesh"] = mesh
        return d
    monkeypatch.setattr(cells, "_load_json", load_json)
    return cells.load(CELL, bench)


@pytest.mark.parametrize("mesh, chips", [
    ({"shape": [2, 1], "axes": ["data", "model"]}, 4),
    ({"shape": [4, 1], "axes": ["model", "data"]}, 4),
    ({"shape": [4, 1], "axes": ["data", "expert"]}, 4),
    ({"shape": [4], "axes": ["data", "model"]}, 4),
    ({"shape": [4, 0], "axes": ["data", "model"]}, 4),
    ({"shape": [2, 2, 1], "axes": ["data", "model"]}, 4),
    ({"shape": [4, 1]}, 4),
    ([4, 1], 4),
    (None, 4),
    (MESH_41, 1),
])
def test_a_mesh_that_is_not_the_cells_chips_is_refused(monkeypatch, mesh,
                                                        chips):
    with pytest.raises(ValueError, match=CELL):
        _load(monkeypatch, mesh, chips)


@pytest.mark.parametrize("mesh, chips, want", [
    (None, 1, None),
    ({"shape": [1, 1], "axes": ["data", "model"]}, 1, ((1, 1),
                                                       ("data", "model"))),
    (MESH_41, 4, ((4, 1), ("data", "model"))),
    ({"shape": [2, 2], "axes": ["data", "model"]}, 4,
     ((2, 2), ("data", "model"))),
    ({"shape": [2, 2, 1], "axes": ["pod", "data", "model"]}, 4,
     ((2, 2, 1), ("pod", "data", "model"))),
])
def test_a_mesh_of_the_cells_chips_loads(monkeypatch, mesh, chips, want):
    assert _load(monkeypatch, mesh, chips).mesh == want


def _rows_of_run(cell, **kw):
    """run_cell's result and the outputs of the window's batches, by batch
    (the closed loop sends the pool in order, so batch i is the same
    queries on every run of a seed)."""
    rows = []

    def spy(svc):
        qb = svc.query_batch

        def query_batch(rs, **k):
            out = qb(rs, **k)
            rows.append(out.copy())
            return out
        svc.query_batch = query_batch
    result, _ = run.run_cell(cell, seed=2 ** 31 + 32, seconds=0.6,
                             trace=False, device="cpu", fault=spy, **kw)
    return result, rows


def test_a_4x1_mesh_of_logical_shards_answers_as_one_device():
    one = perfbench_tiny.tiny(CELL)
    four = perfbench_tiny.tiny(CELL)
    four.spec["mesh"], four.chips = dict(MESH_41), 4
    r1, rows1 = _rows_of_run(one)
    r4, rows4 = _rows_of_run(four, devices=[torch.device("cpu")] * 4)
    assert r1["correct"] and r4["correct"], (r1["checks"], r4["checks"])
    n = min(len(rows1), len(rows4))
    assert n >= 1
    for a, b in zip(rows1[:n], rows4[:n]):
        assert np.array_equal(a, b)
    for r in (r1, r4):
        assert r["device"]["count"] == 1
        assert r["device"]["memory_peak_bytes_by_card"] == [0]


def test_devices_for_a_cell_without_a_mesh_are_refused():
    c = perfbench_tiny.tiny(CELL)
    with pytest.raises(ValueError, match="no mesh"):
        run.run_cell(c, seed=1, seconds=0.1, trace=False, device="cpu",
                     devices=["cpu"])


def _union(evs, t0, t1):
    """The one-card reading before per-card readings: the union of every
    event, cut to the stretch."""
    busy = devtime.merge((max(s, t0), min(e, t1)) for _, s, e, _ in evs)
    return sum(e - s for s, e in busy)


EVENTS = [("type1_vm_kernel<1>", 1.0, 2.0), ("type1_vm_kernel<1>", 1.5, 2.5),
          ("elementwise", 4.0, 5.0), ("Memcpy DtoH", 9.5, 11.0)]


@pytest.mark.parametrize("evs", [EVENTS, EVENTS[2:3], []])
def test_read_stretch_on_one_card_is_the_union(evs):
    st = _FakeStretch(0.0, 10.0, evs)
    rd = devtime.read_stretch(st, [], [])
    assert rd["busy_s"] == _union(st.device_events(), 0.0, 10.0)
    assert rd["busy_s_by_card"] == [rd["busy_s"]]
    assert rd["events_off_cards"] == 0
    assert sum(s for _, s in rd["idle_gaps"]) == pytest.approx(
        10.0 - rd["busy_s"])


@pytest.mark.parametrize("card_ids", [[0, 1], [1, 0], [0, 1, 2]])
def test_read_stretch_on_several_cards_reads_each(card_ids):
    evs = [(*e, 0) for e in EVENTS] + [("type1_vm_kernel<1>", 3.0, 7.0, 1),
                                       ("elementwise", 6.0, 8.0, 1),
                                       ("elementwise", 1.0, 2.0, 5)]
    rd = devtime.read_stretch(_FakeStretch(0.0, 10.0, evs, card_ids),
                              [("query_batch", 0.0, 10.0)],
                              ["type1_vm_kernel"])
    want = {0: 3.0, 1: 5.0, 2: 0.0}
    assert rd["busy_s_by_card"] == pytest.approx([want[c] for c in card_ids])
    assert rd["busy_s"] == pytest.approx(8.0 / len(card_ids))
    assert rd["events_off_cards"] == 1
    assert rd["hand_kernel_events"] == 3
    (label, idle), = rd["idle_gaps"]
    assert label.startswith("query_batch")
    assert idle == pytest.approx(10.0 * len(card_ids) - 8.0)
    ops = dict(rd["device_ops"])
    assert ops["type1_vm_kernel<1>"] == pytest.approx(2.0 + 4.0)


@pytest.mark.parametrize("n, parts", [(10, 1), (10, 4), (1_310_720, 4),
                                      (7, 3), (3, 4)])
def test_doc_shards_are_the_services_split(n, parts):
    assert work.doc_shards(n, parts) == _doc_bounds(n, parts)


def _tiny_corpus():
    return corpus.make_corpus(seed=5, device="cpu", vocab_size=600,
                              embed_dim=8, num_docs=90, mean_words=12.0,
                              zipf_s=1.07, nnz_align=8)


CFG = {"vocab_size": 600, "num_docs": 90, "max_iter": 4}
TR = {"query_words": 7, "batch": 3}


def _whole(data, lo=0, hi=90):
    """The one-card count before per-card counts, of docs [lo, hi)."""
    counts = torch.bincount(torch.from_numpy(data.cols[lo:hi].ravel())
                            .to(torch.int64), minlength=601)
    distinct = int((counts[:600] > 0).sum())
    return work.solve_work(words=[7] * 3, num_docs=hi - lo,
                           nnz=int(data.lengths[lo:hi].sum()),
                           distinct_words=distinct, max_iter=4), distinct


@pytest.mark.parametrize("doc_devices", [["cpu"], ["cpu"] * 4])
def test_one_card_counts_the_whole_problem(doc_devices):
    data = _tiny_corpus()
    (got,) = run._card_works(data, CFG, TR, doc_devices, "cpu")
    assert got == _whole(data)
    assert work.slowest([got[0]]) == (*work.least_seconds(got[0]), 0)


def test_each_card_counts_its_own_shards_and_the_slowest_sets_the_time():
    data = _tiny_corpus()
    cards = [torch.device("cuda", i) for i in (0, 1, 2, 1)]
    got = run._card_works(data, CFG, TR, cards, "cpu")
    (a, b), (c, d), (e, f), (g, h) = work.doc_shards(90, 4)
    assert got[0] == _whole(data, a, b)
    assert got[2] == _whole(data, e, f)
    # card 1 holds shards 1 and 3
    w1, dist1 = got[1]
    w_c, _ = _whole(data, c, d)
    w_g, _ = _whole(data, g, h)
    assert w1["flops"] == w_c["flops"] + w_g["flops"]
    both = np.concatenate([data.cols[c:d], data.cols[g:h]])
    assert dist1 == len(set(both.ravel().tolist()) - {600})
    least, by, i = work.slowest([w for w, _ in got])
    times = [work.least_seconds(w)[0] for w, _ in got]
    assert least == max(times) and i == times.index(max(times))
    assert by in ("operations", "bytes")


def test_the_slowest_card_is_the_largest_one():
    small = work.solve_work(words=[19] * 16, num_docs=1000, nnz=35_000,
                            distinct_words=9_000, max_iter=15)
    large = work.solve_work(words=[19] * 16, num_docs=2000, nnz=70_000,
                            distinct_words=12_000, max_iter=15)
    t_large, by_large = work.least_seconds(large)
    assert work.slowest([small, large, small]) == (t_large, by_large, 1)
