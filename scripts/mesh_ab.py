"""A/B of the one-device service between this tree and another checkout,
on one NVIDIA GPU.

    python3 scripts/mesh_ab.py --other DIR [--reps 20] [--rounds 1]

Runs a fresh process of each tree's ``repro_torch`` in turns (other,
this, this, other, ``--rounds`` times; ``PYTHONPATH=<tree>/src``, kernels
built into ``<tree>/build``). Each builds ``WMDService(device="cuda",
cache_capacity=1024, mcache_capacity=1024)`` on ``paper_5k``
(``make_corpus(seed=0)``) with ``chip_smoke.py`` phase 3's two batches of
16 ``zipf_query_stream(seed=1)`` queries, and times the calls of phases 3,
6 and 8 warm: ``query_batch`` of batch 2, ``top_k_batch(batch 2, 10,
prune=True)`` (the per-query rerank) and ``query(r)`` of batch 1's first
query. A call's numbers: the median host wall in ms (a device synchronize
at both ends) over ``--reps`` calls, and the device busy ms of one call
under torch.profiler. Prints the card's name and power limit, one JSON
line a turn, each tree's median over its turns, and whether the
trees' outputs have the same sha256.
"""
import argparse
import hashlib
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
CALLS = ("query_batch", "pruned_per_query", "query")


def _worker(reps: int) -> dict:
    """One turn in this process (its ``repro_torch`` is the tree's)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.sinkhorn_wmd import config
    from repro_torch.data.corpus import make_corpus, zipf_query_stream
    from repro_torch.serving import WMDService

    cfg = config("paper_5k")
    data = make_corpus(vocab_size=cfg.vocab_size, embed_dim=cfg.embed_dim,
                       num_docs=cfg.num_docs, num_queries=1, seed=0)
    stream = zipf_query_stream(vocab_size=cfg.vocab_size, query_words=19,
                               seed=1)
    batch1 = [next(stream) for _ in range(16)]
    batch2 = [next(stream) for _ in range(16)]
    svc = WMDService(cfg=cfg, vecs=data.vecs, ell=data.ell,
                     cache_capacity=1024, mcache_capacity=1024)
    calls = {
        "query_batch": lambda: svc.query_batch(batch2),
        "pruned_per_query": lambda: svc.top_k_batch(batch2, 10, prune=True),
        "query": lambda: svc.query(batch1[0]),
    }
    svc.query_batch(batch1)                  # batch 1 warms the K cache
    out, sha = {}, hashlib.sha256()
    for name, call in calls.items():
        for _ in range(3):
            res = call()
        for part in (res if isinstance(res, tuple) else (res,)):
            sha.update(np.ascontiguousarray(part).tobytes())
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA) / 1e3
        out[name] = {"wall_ms": statistics.median(walls),
                     "device_ms": busy if busy > 0 else None}
    return {"calls": out, "sha256": sha.hexdigest(),
            "mesh": repr(getattr(svc, "mesh", None))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=pathlib.Path, default=None,
                    help="root of another checkout to compare with")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        import torch
        if not torch.cuda.is_available():
            print("mesh_ab: no CUDA device", file=sys.stderr)
            return 1
        print(json.dumps(_worker(args.reps)))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    trees = {"this": ROOT}
    if args.other is not None:
        trees["other"] = args.other.resolve()
    order = (["other", "this", "this", "other"] if "other" in trees
             else ["this", "this"]) * args.rounds
    runs: dict = {k: [] for k in trees}
    for tree in order:
        env = dict(os.environ, PYTHONPATH=str(trees[tree] / "src"))
        proc = subprocess.run(
            [sys.executable, str(pathlib.Path(__file__).resolve()),
             "--worker", "--reps", str(args.reps)],
            cwd=trees[tree], env=env, capture_output=True, text=True,
            timeout=1800)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[tree].append(res)
        print(json.dumps({"tree": tree, **res}))
    for tree, rs in runs.items():
        med = {c: {k: statistics.median(r["calls"][c][k] or float("nan")
                                        for r in rs)
                   for k in ("wall_ms", "device_ms")} for c in CALLS}
        print(f"[{tree}] " + "; ".join(
            f"{c} wall {m['wall_ms']:.4f} ms, device {m['device_ms']:.4f} ms"
            for c, m in med.items()))
    shas = {r["sha256"] for rs in runs.values() for r in rs}
    print(f"outputs' sha256 {'equal' if len(shas) == 1 else 'DIFFER'}: "
          f"{sorted(shas)}")
    return 0 if len(shas) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
