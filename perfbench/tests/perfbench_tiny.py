"""Shared helpers of the benchmark's CPU tests: the repo's ``src`` and root
on the path, and a cell shrunk to a size a CPU test holds."""
from __future__ import annotations

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from perfbench import cells  # noqa: E402

# the plain CPU route spells the cost rows by the matmul expansion, which
# puts a word's own column near 1e-2 instead of 0 (the card's kernel puts
# it at 0): the CPU tests hold a sound run to this, not to a cell's limit
CPU_ROUTE_LIMIT = 5e-3


def tiny(name: str, *, docs: int = 300, vocab: int = 1024, dim: int = 32,
         pool: int = 512):
    """The cell ``name`` of BENCHMARK.json at a CPU test's size."""
    c = cells.load(name, _bench_with_serve())
    c.config.update(vocab_size=vocab, embed_dim=dim, num_docs=docs,
                    max_iter=6)
    c.traffic.update(pool=pool)
    if c.traffic["loop"] == "closed":
        c.traffic.update(batch=8)
        c.spec["sample"] = {"batches": 2}
    else:
        c.traffic.update(rate_qps=40.0, warm_batches=[1, 2])
        c.spec["sample"] = {"requests": 6}
    c.spec["limits"] = {k: CPU_ROUTE_LIMIT for k in c.spec["limits"]}
    return c


def _bench_with_serve() -> dict:
    """BENCHMARK.json, with the serve cell's entry if it was left out (its
    files stay under perfbench/ for a later change)."""
    bench = cells.benchmark()
    names = {w["name"] for w in bench["workloads"]}
    if "prod_5m_shard4.serve_top10" not in names:
        bench["workloads"].append({
            "name": "prod_5m_shard4.serve_top10", "config": "prod_5m_shard4",
            "traffic": "serve_top10", "chips": 1, "why": "-"})
    return bench
