"""The port's `LiveCorpus` (`repro_torch.data.live_corpus`) against the
reference's (`repro.data.live_corpus`).

* One seeded history -- adds, upserts, removes of live and never-added
  ids, an empty doc, a doc wider than any before it, compactions and an
  injected crash inside a compaction with a reopen -- run through both
  classes gives equal base and delta ELL arrays, `locations()`,
  `live_empty_mask()`, `stats()`, the same files on disk and the same
  snapshot bytes (so the same sha256 in ``meta.json``), after every step.
* A directory written by the reference opens in the port with equal
  `live_docs()`, and the reverse, and each goes on writing it.
* The port's own contracts: validation before the WAL, compaction GC,
  concurrent writers during a compaction (the ``_pending`` re-log), and
  the late-bound tracer and lock-hold histogram.
"""
import json
import os
import threading

import numpy as np
import pytest

from repro.data.live_corpus import LiveCorpus as RefCorpus
from repro.serving.faultinject import CrashInjector as RefInjector
from repro.serving.faultinject import InjectedCrash as RefCrash
from repro_torch.data import LiveCorpus
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.serving.faultinject import CrashInjector, InjectedCrash

V = 96


def _doc(rng, nnz=None):
    nnz = int(rng.integers(2, 8)) if nnz is None else nnz
    wids = rng.choice(V, size=nnz, replace=False)
    cnts = rng.integers(1, 9, size=nnz)
    return [(int(w), float(c)) for w, c in zip(wids, cnts)]


def _history(seed=3):
    """(op, args) steps; "crash" kills the next compaction at
    compact.snapshot.tmp and reopens the directory."""
    rng = np.random.default_rng(seed)
    ops = [("add", list(range(10)), [_doc(rng) for _ in range(10)])]
    ops += [("add", [3], [[(0, 1.0)]]),                  # upsert, wrong
            ("remove", [5, 999]),                        # live + never
            ("compact",),
            ("add", [12, 13], [_doc(rng), []]),          # an empty doc
            ("add", [3], [_doc(rng)]),                   # corrected
            ("add", [20], [_doc(rng, nnz=21)]),          # widens the delta
            ("remove", [12]),
            ("crash",),
            ("add", list(range(30, 41)), [_doc(rng) for _ in range(11)]),
            ("compact",),
            ("add", [41], [_doc(rng)])]
    return ops


def _state(lc):
    ids, seg, row = lc.locations()
    return {"base": (lc.base_ell.cols, lc.base_ell.vals),
            "delta": (lc.delta_ell.cols, lc.delta_ell.vals),
            "loc": (ids, seg, row), "empty": lc.live_empty_mask(),
            "stats": lc.stats(), "docs": lc.live_docs()}


def _files(path):
    out = {}
    for root, _, names in os.walk(path):
        for n in names:
            full = os.path.join(root, n)
            with open(full, "rb") as f:
                out[os.path.relpath(full, path)] = f.read()
    return out


def _assert_same(a, b, versions=True):
    """Equal layouts and stats; ``versions=False`` leaves out the
    in-memory mutation counters, which a reopen restarts."""
    for key in ("base", "delta", "loc"):
        for x, y in zip(a[key], b[key]):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
    np.testing.assert_array_equal(a["empty"], b["empty"])
    drop = () if versions else ("version", "base_version")
    assert ({k: v for k, v in a["stats"].items() if k not in drop}
            == {k: v for k, v in b["stats"].items() if k not in drop})
    assert a["docs"] == b["docs"]


def test_one_history_through_both_classes_is_identical(tmp_path):
    pairs = ((RefCorpus, RefInjector, RefCrash, tmp_path / "ref"),
             (LiveCorpus, CrashInjector, InjectedCrash, tmp_path / "port"))
    hooks = [inj() for _, inj, _, _ in pairs]
    corpora = [cls(str(p), V, crash_hook=h)
               for (cls, _, _, p), h in zip(pairs, hooks)]
    for op in _history():
        for i, ((cls, _, crash, p), hook) in enumerate(zip(pairs, hooks)):
            lc = corpora[i]
            if op[0] == "add":
                assert lc.add_docs(op[1], op[2]) == len(op[1])
            elif op[0] == "remove":
                lc.remove_docs(op[1])
            elif op[0] == "compact":
                lc.compact()
            else:
                hook.target = hook.count + 2       # compact.snapshot.tmp
                with pytest.raises(crash):
                    lc.compact()
                corpora[i] = cls(str(p), V)        # recover from disk
        _assert_same(_state(corpora[0]), _state(corpora[1]))
        assert _files(pairs[0][3]) == _files(pairs[1][3])
    metas = [json.loads(_files(p)["snapshot_00000002/meta.json"])
             for *_, p in pairs]
    assert metas[0] == metas[1] and metas[0]["num_docs"] == 22
    for lc in corpora:
        lc.close()


@pytest.mark.parametrize("writer,reader", [(RefCorpus, LiveCorpus),
                                           (LiveCorpus, RefCorpus)],
                         ids=["ref_to_port", "port_to_ref"])
def test_directory_opens_in_the_other_package(tmp_path, writer, reader):
    """A snapshot plus a WAL tail written by one package recovers in the
    other with equal live docs and layout, and the reader extends it."""
    rng = np.random.default_rng(11)
    lc = writer(str(tmp_path), V)
    lc.add_docs(list(range(12)), [_doc(rng) for _ in range(12)])
    lc.compact()
    lc.add_docs([4, 50], [_doc(rng), _doc(rng)])
    lc.remove_docs([7])
    want = _state(lc)
    lc.close()
    other = reader(str(tmp_path), V)
    _assert_same(_state(other), want, versions=False)
    other.add_docs([60], [_doc(rng)])
    other.compact()
    docs = other.live_docs()
    other.close()
    again = writer(str(tmp_path), V)
    assert again.live_docs() == docs and again.gen == 2
    again.close()


def test_validation_rejects_before_the_wal(tmp_path):
    lc = LiveCorpus(str(tmp_path), V)
    for ids, docs in (([1], [[(V, 1.0)]]), ([1], [[(0, -1.0)]]),
                      ([1], [[(0, float("nan"))]]), ([1, 2], [[]])):
        with pytest.raises(ValueError):
            lc.add_docs(ids, docs)
    assert lc.stats()["wal_bytes"] == 0 and lc.num_live == 0
    lc.close()


def test_compaction_collects_old_generations(tmp_path):
    lc = LiveCorpus(str(tmp_path), V)
    lc.add_docs([0, 1], [[(1, 1.0)], [(2, 1.0)]])
    lc.compact()
    lc.add_docs([2], [[(3, 1.0)]])
    lc.compact()
    assert sorted(os.listdir(tmp_path)) == ["snapshot_00000002",
                                            "wal_00000002.log"]
    st = lc.stats()
    assert (st["gen"], st["num_live"], st["base_rows"], st["delta_rows"]) \
        == (2, 3, 8, 0)
    lc.close()


def test_writes_during_a_compaction_are_relogged(tmp_path):
    """Writers racing a compaction's build window land in the new
    generation's WAL (the ``_pending`` re-log), so a reopen after the
    compaction sees them; the tracer and the lock-hold histogram are
    late-bound."""
    lc = LiveCorpus(str(tmp_path), V)
    lc.add_docs(list(range(8)), [[(i, 1.0)] for i in range(8)])
    tracer, reg = Tracer(), MetricsRegistry()
    lc.tracer, lc.metrics = tracer, reg
    started, release = threading.Event(), threading.Event()

    def hook(name):
        if name == "compact.built":
            started.set()
            assert release.wait(30)

    lc._hook = hook
    t = threading.Thread(target=lc.compact)
    t.start()
    assert started.wait(30)
    lc.add_docs([100], [[(9, 2.0)]])          # during the build window
    lc.remove_docs([0])
    release.set()
    t.join(timeout=30)
    assert not t.is_alive()
    lc._hook = lambda name: None
    assert lc.gen == 1
    ids, seg, _ = lc.locations()
    assert 100 in ids.tolist() and 0 not in ids.tolist()
    assert seg[ids.tolist().index(100)] == 1   # re-applied to the delta
    names = [e["event"] for e in tracer.events]
    assert names.index("compact.begin") < names.index("compact.done")
    assert reg.histogram("wmd_compact_lock_hold_seconds").count == 2
    lc.close()
    rec = LiveCorpus(str(tmp_path), V)
    assert rec.live_docs() == lc.live_docs()
    rec.close()
