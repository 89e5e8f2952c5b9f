"""End-to-end serving example on the PyTorch / CUDA port: batched WMD queries
against a sharded corpus.

    PYTHONPATH=src python examples/torch_wmd_query_service.py [--devices 8]
    PYTHONPATH=src python examples/torch_wmd_query_service.py \\
        --zipf-stream --cache-capacity 1024
    PYTHONPATH=src python examples/torch_wmd_query_service.py \\
        --coalesce --clients 8
    PYTHONPATH=src python examples/torch_wmd_query_service.py \\
        --top-k 8 --prune --docs 1024
    PYTHONPATH=src python examples/torch_wmd_query_service.py \\
        --offline 256 --top-k 8 --prune --cache-dir build/wmd-kernels

The port of `examples/wmd_query_service.py`, with its flags, defaults and
printed lines, plus ``--device``: ``cuda`` (the default) serves through the
hand-written CUDA kernels and raises where there is no card; ``cpu`` runs
their plain PyTorch versions. No kernel gives way to its plain version.

Loads a corpus once onto the mesh (vocab-striped K + doc-sharded ELL),
then serves a stream of queries (bucketed by padded v_r; the doc shards'
partial sums folded in a fixed order each Sinkhorn iteration). The mesh is
``(N // model_par, model_par)`` over ``--devices N`` logical devices,
placed round-robin on the visible cards (all on ``cuda:0`` on a one-card
machine: the program's logic, not its speed across cards; on the CPU with
``--device cpu``); ``--devices 0`` takes one a visible card.

The default mode answers ``top_k(q, 3)`` for each query through the
per-query program (#5 for its K and K.*M rows, their two vocab-major
copies, 15 #1, one #2). ``--batch-queries`` solves all queries in one
batched (Q, v_r, N) dispatch (15 #3 and one #4) and times it against
`query_batch_sequential`; ``--docs-chunk`` cache-blocks it over doc chunks
(the kernels' doc tile).

--zipf-stream demos the cross-query K cache on a realistic skewed
workload: batches drawn from `repro_torch.data.zipf_query_stream` repeat
word ids across queries, so after a few batches most precompute rows are
already resident (`core.kcache`) and `query_batch` only computes the
misses (#6) -- watch the per-batch hit rate climb and the precompute
phase shrink.

--top-k K --prune demos the two-tier pruned retriever: every doc is scored
with the doc-side RWMD lower bounds (`core.rwmd`: #7's cost rows, #9 and
#8), and the exact Sinkhorn rerank only runs on docs whose bound cannot
rule them out of the top-k. The demo prints the solves-avoided fraction
and *verifies* the pruned answer bitwise against `top_k_scan_batch`, the
exhaustive scan through the same chunked engine -- the exactness contract
in one run.

--coalesce demos the async admission layer: ``--clients`` concurrent
closed-loop clients each submit single queries to a
`serving.coalescer.QueryCoalescer` (via `svc.async_service`) and the
coalescer micro-batches them into full `query_batch` dispatches -- the
batch-size histogram and client-side latency percentiles it prints are the
whole story. Warmup runs through the program-shape registry
(`serving.warmup.ShapeRegistry`): every pow2 Q bucket the coalescer can
dispatch runs once before the first client arrives.

--offline N demos the bulk-scoring mode (`serving.offline.run_offline`):
N Zipf queries scored at maximum batch occupancy -- no admission windows,
pure throughput, the MLPerf offline scenario. With --top-k it uses union
rerank batching and verifies the answer bitwise against the exhaustive
scan. Add --cache-dir DIR to keep the kernels' build directory there
(`serving.enable_compilation_cache`): the second run of the same command,
in a new process, loads the libraries and reports zero builds
("compiles").
"""
import argparse
import itertools
import time

import numpy as np

from repro_torch.configs.sinkhorn_wmd import WMDConfig
from repro_torch.data import make_corpus, zipf_query_stream
from repro_torch.launch.mesh import logical_devices, make_mesh
from repro_torch.serving import (ShapeRegistry, WMDService, closed_loop,
                                 enable_compilation_cache, run_offline, warm)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=0,
                    help="logical devices of the mesh, round-robin on the "
                         "visible cards (or the CPU); 0: one a visible card")
    ap.add_argument("--docs", type=int, default=512)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--queries", type=int, default=6)
    ap.add_argument("--batch-queries", action="store_true",
                    help="solve all queries in one batched (Q, v_r, N) "
                         "program and report throughput vs the loop")
    ap.add_argument("--docs-chunk", type=int, default=0,
                    help="cache-block the batched solve over doc chunks "
                         "of this size (0 = unchunked)")
    ap.add_argument("--zipf-stream", action="store_true",
                    help="serve batches from a Zipf query stream through "
                         "the cross-query K cache and print per-batch "
                         "hit rate + phase split")
    ap.add_argument("--cache-capacity", type=int, default=1024,
                    help="resident K/K.M rows for --zipf-stream and "
                         "--coalesce")
    ap.add_argument("--stream-batches", type=int, default=8)
    ap.add_argument("--coalesce", action="store_true",
                    help="fire concurrent single-query clients at the "
                         "async coalescer and print the batch-size "
                         "histogram + latency percentiles")
    ap.add_argument("--clients", type=int, default=8,
                    help="concurrent closed-loop clients for --coalesce")
    ap.add_argument("--requests-per-client", type=int, default=12)
    ap.add_argument("--coalesce-window-ms", type=float, default=5.0)
    ap.add_argument("--top-k", type=int, default=0,
                    help="> 0: run the two-tier pruned top-k demo with "
                         "this k (add --prune to prune; without it the "
                         "demo still verifies but prunes nothing)")
    ap.add_argument("--prune", action="store_true",
                    help="prune the top-k rerank with the RWMD prefilter "
                         "and print solves-avoided (verified bitwise "
                         "against the exact scan)")
    ap.add_argument("--prune-chunk", type=int, default=64,
                    help="doc-block size of the pruned rerank")
    ap.add_argument("--offline", type=int, default=0, metavar="N",
                    help="> 0: bulk-score N Zipf queries at max batch "
                         "occupancy (combine with --top-k/--prune for "
                         "union-rerank retrieval, verified vs the scan)")
    ap.add_argument("--cache-dir", default="",
                    help="keep the kernels' build directory here; a "
                         "second run of the same shapes starts with zero "
                         "builds")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand-written kernels, the default) or "
                         "cpu (their plain PyTorch versions)")
    args = ap.parse_args(argv)

    if args.cache_dir:
        # before the first kernel launch: libraries are named by a hash of
        # their source and flags, so a later process loads them from here
        enable_compilation_cache(args.cache_dir)

    devices = logical_devices(args.device, args.devices)
    n_dev = len(devices)
    model_par = 2 if n_dev % 2 == 0 and n_dev > 1 else 1
    mesh = make_mesh((n_dev // model_par, model_par), ("data", "model"),
                     devices=devices)
    print(f"mesh: data={n_dev // model_par} model={model_par}")

    cfg = WMDConfig(name="svc", vocab_size=args.vocab, embed_dim=64,
                    num_docs=args.docs, nnz_max=64, v_r=32, lamb=1.0,
                    max_iter=15)
    data = make_corpus(vocab_size=cfg.vocab_size, embed_dim=cfg.embed_dim,
                       num_docs=cfg.num_docs, num_queries=args.queries,
                       query_words=19, seed=0)
    t0 = time.perf_counter()
    svc = WMDService(mesh=mesh, cfg=cfg, vecs=data.vecs, ell=data.ell,
                     docs_chunk=args.docs_chunk or None,
                     prune_chunk=args.prune_chunk,
                     cache_capacity=(args.cache_capacity
                                     if args.zipf_stream or args.coalesce
                                     or args.top_k or args.offline else 0))
    print(f"corpus loaded+sharded in {time.perf_counter() - t0:.2f}s "
          f"(nnz={data.nnz})")

    def zipf_queries(n):
        stream = zipf_query_stream(vocab_size=cfg.vocab_size,
                                   query_words=13, s=1.3, seed=0)
        return list(itertools.islice(stream, n))

    if args.offline:
        # bulk-scoring mode: the whole workload is known up front, so the
        # scheduler is trivial and maximal -- full buckets, 100% occupancy.
        # Warmup first (registry pass), so the timed run never builds; with
        # --cache-dir a SECOND process run reports 0 compiles here.
        qs = zipf_queries(args.offline)
        max_batch = 16
        kinds = ("plain",) if not args.top_k else ("top_k_union",)
        reg = ShapeRegistry.from_service(
            svc, max_batch=max_batch,
            ks=(args.top_k,) if args.top_k else (), kinds=kinds)
        rep = warm(svc, reg)
        print(f"warmup: {len(reg)} shapes, {rep.compiles} compiles "
              f"({rep.compile_s:.2f}s), {rep.persistent_hits} persisted-"
              f"cache hits in {rep.wall_s:.2f}s")
        off = run_offline(svc, qs,
                          k=args.top_k or None, max_batch=max_batch)
        print(f"offline: {off.n} queries in {off.batches} batches, "
              f"{off.throughput_qps:.1f} q/s")
        out = {"mode": "offline", "svc": svc, "warmup": rep, "offline": off}
        if args.top_k and args.prune:
            idx_s, d_s = svc.top_k_scan_batch(qs, args.top_k)
            exact = (np.array_equal(off.topk_idx, idx_s)
                     and np.array_equal(off.topk_dist, d_s))
            print(f"  union rerank: {off.rerank_programs} programs, "
                  f"solves avoided {off.solves_avoided:.1%}, "
                  f"bitwise-identical to the exact scan: {exact}")
            if not exact:
                raise AssertionError("offline top-k must equal the exact "
                                     "scan")
            out["exact"] = exact
        return out

    if args.top_k:
        # two-tier retrieval: RWMD prefilter + exact Sinkhorn rerank. The
        # pruned answer is verified BITWISE against the exhaustive scan
        # through the same chunked engine -- fewer solves, same bits.
        qs = zipf_queries(args.queries)
        svc.top_k_batch(qs, args.top_k, prune=args.prune)  # warm
        t0 = time.perf_counter()
        idx_p, d_p = svc.top_k_batch(qs, args.top_k, prune=args.prune)
        dt = time.perf_counter() - t0
        for i in range(len(qs)):
            print(f"query {i}: top{args.top_k}={idx_p[i].tolist()} "
                  f"d={np.round(d_p[i], 3).tolist()}")
        out = {"mode": "top_k", "svc": svc, "idx": idx_p, "dist": d_p,
               "seconds": dt}
        if args.prune:
            ps = dict(svc.last_prune_stats)
            idx_s, d_s = svc.top_k_scan_batch(qs, args.top_k)
            exact = (np.array_equal(idx_p, idx_s)
                     and np.array_equal(d_p, d_s))
            print(f"pruned top-{args.top_k}: Q={len(qs)} in "
                  f"{dt * 1e3:.1f} ms, solves avoided "
                  f"{ps['solves_avoided']:.1%} "
                  f"({ps['exact_solves']}/{ps['scan_solves']} exact "
                  f"solves, {ps['rerank_programs']} rerank programs, "
                  f"bound {ps['bound_s'] * 1e3:.1f} ms)")
            print(f"bitwise-identical to the exact scan: {exact}")
            if not exact:
                raise AssertionError("pruned top-k must equal the exact "
                                     "scan")
            out.update(prune_stats=ps, exact=exact)
        else:
            print(f"full-scan top-{args.top_k}: Q={len(qs)} in "
                  f"{dt * 1e3:.1f} ms (add --prune to skip provably "
                  f"out-of-top-k solves)")
        return out

    if args.coalesce:
        # concurrent clients each submit ONE query at a time; the coalescer
        # turns that stream into full (Q, v_r, N) dispatches -- mean batch
        # size is the amortization the paper's batching wins come from
        qs = zipf_queries(args.clients * args.requests_per_client)
        max_batch = max(args.clients, 2)
        with svc.async_service(window_ms=args.coalesce_window_ms,
                               max_batch=max_batch,
                               max_queue=4 * max_batch) as co:
            rep = co.warm_registry(queries=qs)   # every pow2 bucket once
            print(f"  warmed {len(rep.shapes)} shapes "
                  f"({rep.compiles} compiles, {rep.compile_s:.2f}s)")
            res = closed_loop(co.submit, qs, concurrency=args.clients)
            st = co.stats()
        print(f"coalesce: {args.clients} clients x "
              f"{args.requests_per_client} requests, "
              f"window={args.coalesce_window_ms:g} ms -> "
              f"{res.throughput_qps:.1f} q/s, "
              f"mean batch {st.mean_batch_size:.1f}")
        print(f"  dispatches={st.dispatches} (fill={st.dispatch_fill} "
              f"window={st.dispatch_window} drain={st.dispatch_drain}) "
              f"batch-size hist={st.batch_size_hist}")
        print(f"  client latency ms: p50={res.percentile_ms(50):.1f} "
              f"p95={res.percentile_ms(95):.1f} "
              f"p99={res.percentile_ms(99):.1f}"
              + (f"  cache hit_rate={st.hit_rate:.2f}"
                 if st.hit_rate is not None else ""))
        return {"mode": "coalesce", "svc": svc, "warmup": rep,
                "loadgen": res, "stats": st}

    if args.zipf_stream:
        # realistic skewed workload in one line: successive batches share
        # most of their vocabulary, so the cross-query K cache converges to
        # serving the precompute almost entirely from resident rows
        stream = zipf_query_stream(vocab_size=cfg.vocab_size,
                                   query_words=13, s=1.3, seed=0)
        q = max(args.queries, 8)
        batches = []
        for b in range(args.stream_batches):
            batch = [next(stream) for _ in range(q)]
            dists = svc.query_batch(batch)
            st = svc.last_batch_stats
            print(f"batch {b}: Q={q} top1={int(np.argmin(dists[0]))} "
                  f"hit_rate={st['hit_rate']:.2f} "
                  f"precompute={st['precompute_s'] * 1e3:.1f} ms "
                  f"solve={st['solve_s'] * 1e3:.1f} ms")
            batches.append(dict(st))
        cs = svc.cache_stats
        print(f"cache: cumulative hit_rate={cs.hit_rate:.2f} "
              f"evictions={cs.evictions} resident={svc.cache_resident}")
        return {"mode": "zipf_stream", "svc": svc, "q": q,
                "batches": batches}

    if args.batch_queries:
        # run BOTH paths once outside timing so the A/B compares solves only
        svc.query_batch(data.queries)
        svc.query_batch_sequential(data.queries)
        t0 = time.perf_counter()
        dists = svc.query_batch(data.queries)
        dt_b = time.perf_counter() - t0
        t0 = time.perf_counter()
        svc.query_batch_sequential(data.queries)
        dt_s = time.perf_counter() - t0
        for i, d in enumerate(dists):
            idx = np.argsort(d)[:3]
            print(f"query {i}: top3={idx.tolist()} "
                  f"d={np.round(d[idx], 3).tolist()}")
        q = len(data.queries)
        print(f"batched Q={q}: {dt_b * 1e3:.1f} ms ({q / dt_b:.1f} q/s) "
              f"vs sequential {dt_s * 1e3:.1f} ms ({q / dt_s:.1f} q/s) "
              f"-> {dt_s / dt_b:.2f}x")
        return {"mode": "batch_queries", "svc": svc, "dists": dists,
                "batched_s": dt_b, "sequential_s": dt_s}

    lat, top = [], []
    for i, q in enumerate(data.queries):
        t0 = time.perf_counter()
        idx, dist = svc.top_k(q, k=3)
        dt = time.perf_counter() - t0
        lat.append(dt)
        top.append((idx, dist))
        print(f"query {i}: top3={idx.tolist()} "
              f"d={np.round(dist, 3).tolist()} ({dt * 1e3:.1f} ms)")
    lat = np.array(lat[1:]) * 1e3  # drop the first (warm) query
    print(f"steady-state latency: p50={np.percentile(lat, 50):.1f} ms "
          f"p95={np.percentile(lat, 95):.1f} ms")
    return {"mode": "top_k_3", "svc": svc, "top": top, "latency_ms": lat}


if __name__ == "__main__":
    main()
