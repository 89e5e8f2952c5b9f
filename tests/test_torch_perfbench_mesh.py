"""The benchmark's four-card cell, ``prod_5m.bulk_q16``, on the CPU:

* `perfbench.cells` loads it with its files: four chips on a (4, 1) mesh,
  the whole of ``config('prod_5m')`` and nothing cut, ``qps`` and all eight
  per-layer metrics;
* the readers of its two metrics of its own, ``card_balance`` and
  ``peer_copy_share``, on hand-made traced readings;
* a (4, 1) `WMDService` of logical shards answers within the cell's limit
  of the plain reference (`perfbench/reference.py`), which the reference
  computed in TF32 does not.
"""
import dataclasses
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import cells, compare, corpus, run  # noqa: E402
from repro_torch.configs.sinkhorn_wmd import config  # noqa: E402
from repro_torch.core.formats import EllDocs  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.serving.wmd_service import WMDService  # noqa: E402

CELL = "prod_5m.bulk_q16"
PER_LAYER = ["host_ms", "kcache_hit_rate", "precompute_ms", "solve_ms",
             "solve_roofline", "idle_share.bulk", "card_balance",
             "peer_copy_share"]


def test_the_four_card_cell_loads_with_its_files():
    c = cells.load(CELL)
    assert c.chips == 4
    assert c.mesh == ((4, 1), ("data", "model"))
    assert c.config["num_docs"] == config("prod_5m").num_docs == 5_242_880
    assert [m["name"] for m in c.end_to_end] == ["qps", "setup_s"]
    assert [m["name"] for m in c.per_layer] == PER_LAYER
    for m in c.end_to_end + c.per_layer:
        assert callable(cells.reader(m["name"]))
    assert c.spec["service"] == {"cache_capacity": 1024}
    assert c.spec["sample"] == {"batches": 1}
    assert c.spec["limits"] == {"dist_rel_err": 3e-5}


def test_the_configuration_is_prod_5m_uncut():
    c = cells.load(CELL)
    shard = json.loads((ROOT / "perfbench" / "configs"
                        / "prod_5m_shard4.json").read_text())
    assert c.config["reduced"] == {}
    assert set(c.config) == set(shard)
    numbers = {k for k, v in shard.items()
               if isinstance(v, (int, float)) and k != "num_docs"}
    assert {k: c.config[k] for k in numbers} == {k: shard[k]
                                                 for k in numbers}
    # what `perfbench/run.py` hands the program: config('prod_5m') whole
    got = dataclasses.asdict(run._config(c.config))
    want = dataclasses.asdict(config("prod_5m"))
    assert {k: v for k, v in got.items() if k != "name"} == {
        k: v for k, v in want.items() if k != "name"}
    entry = next(e for e in cells.benchmark()["configs"]
                 if e["name"] == "prod_5m")
    assert entry["reduced"] == [] and entry["file"].endswith("prod_5m.json")


def _m(busy, ops=(), window=2.0):
    return {"loop": "closed",
            "trace": {"busy_s": sum(busy) / len(busy), "busy_s_by_card": busy,
                      "window_s": window, "device_ops": [list(o)
                                                         for o in ops]}}


PTOP = "Memcpy PtoP (Device -> Device)"
OPS = [("void (anonymous namespace)::type1_vm_kernel<1, true>", 5.6),
       (PTOP, 0.05), ("Memcpy DtoH (Device -> Pageable)", 0.2)]


@pytest.mark.parametrize("m, balance, share", [
    (_m([1.9], OPS), None, None),                        # one card
    (_m([1.8, 1.8, 1.8, 1.8], OPS), 1.0, 0.05 / 2.0),    # four even cards
    (_m([1.9, 1.5, 1.2, 1.6], OPS + [(PTOP[:40], 0.03)]),
     1.2 / 1.9, 0.08 / 2.0),                             # four uneven cards
    (_m([1.8, 1.7, 1.7, 1.6], OPS[:1] + OPS[2:]), 1.6 / 1.8, 0.0),  # no PtoP
    (_m([0.0, 0.0, 0.0, 0.0]), None, 0.0),               # no events at all
    ({"loop": "closed"}, None, None),                    # untraced
])
def test_card_balance_and_peer_copy_share(m, balance, share):
    got_b = cells.reader("card_balance")(m)
    got_s = cells.reader("peer_copy_share")(m)
    assert (got_b is None) == (balance is None)
    assert (got_s is None) == (share is None)
    if balance is not None:
        assert got_b == pytest.approx(balance)
    if share is not None:
        assert got_s == pytest.approx(share)


# -- a (4, 1) service of logical shards against the plain reference ----------

CFG = dict(name="prod_5m_small", vocab_size=1024, embed_dim=32, num_docs=300,
           nnz_max=128, v_r=32, lamb=1.0, max_iter=15, mean_words=35.0,
           zipf_s=1.07, nnz_align=8)


def _problem(seed: int):
    """The harness's corpus and queries at a CPU test's size, with the
    embeddings rounded to whole numbers: the plain CPU route spells the
    cost rows by the matmul expansion (a word's own column near 1e-2, not
    0 as on the card), which rounding makes exact, so what is compared is
    the mesh program's Sinkhorn solve."""
    data = corpus.make_corpus(seed=seed, device="cpu",
                              vocab_size=CFG["vocab_size"],
                              embed_dim=CFG["embed_dim"],
                              num_docs=CFG["num_docs"],
                              mean_words=CFG["mean_words"],
                              zipf_s=CFG["zipf_s"],
                              nnz_align=CFG["nnz_align"])
    data = dataclasses.replace(data, vecs=torch.round(data.vecs))
    pool = corpus.make_queries(seed=seed, device="cpu",
                               vocab_size=CFG["vocab_size"], n=64, words=19,
                               zipf_s=1.07)
    return data, pool


def _service(data, mesh=None):
    ell = EllDocs(cols=data.cols, vals=data.vals,
                  num_vocab=CFG["vocab_size"])
    place = {"device": "cpu"} if mesh is None else {"mesh": mesh}
    return WMDService(cfg=run._config(CFG), vecs=data.vecs, ell=ell,
                      cache_capacity=1024, **place)


def test_a_4x1_service_is_within_the_cells_limit_of_the_reference():
    data, pool = _problem(2 ** 31 + 33)
    limit = cells.load(CELL).spec["limits"]["dist_rel_err"]
    rows = np.arange(16)
    dense = corpus.DenseRows(16, CFG["vocab_size"])
    qs = [dense.put(j, pool.ids[j], pool.weights[j]) for j in rows]
    four = _service(data, make_mesh((4, 1), ("data", "model"),
                                    devices=[torch.device("cpu")] * 4))
    out = four.query_batch(qs)
    assert np.array_equal(out, _service(data).query_batch(qs))
    ref = compare.ref_rows(data, pool, rows, CFG, precision="float32",
                           device="cpu").numpy()
    assert compare.rel_err(out, ref) <= limit
    ctl = compare.ref_rows(data, pool, rows, CFG, precision="tf32",
                           device="cpu").numpy()
    assert compare.rel_err(ctl, ref) > limit
