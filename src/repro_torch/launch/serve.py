"""Serving launcher for the port: the Sinkhorn-WMD query service, or a
language model's prefill + greedy decode loop.

    python -m repro_torch.launch.serve --arch <lm arch> [--smoke]
        [--batch B] [--prefill-len T] [--decode-steps N] [--device D]
    python -m repro_torch.launch.serve --arch sinkhorn-wmd [--smoke]
        [--batch-queries] [--num-queries N] [--impl kernel|fused|unfused]
        [--docs-chunk D] [--tol T] [--top-k K] [--prune]
        [--coalesce-window-ms W [--max-batch B] [--max-queue Q]
         [--deadline-ms D] [--rate-qps R] [--requests N] [--resilience]
         [--brownout-queue D] [--stats-out F] [--trace-out F]
         [--metrics-port P]
         [--ingest-stream N [--live-dir DIR] [--compact-every OPS]]]
        [--offline QUERIES [--offline-out OUT] [--rerank union|per_query]]
        [--warmup] [--cache-dir DIR] [--device cuda|cpu]
        [--devices N] [--mesh DxM | PxDxM]

Builds the synthetic corpus of the configuration (``--smoke``: the tiny
smoke config; default: ``paper_5k``), serves its queries through
`repro_torch.serving.WMDService` and prints each query's nearest docs and
the latency. ``--batch-queries`` solves all queries in one batched call
(timed after a first warm call); otherwise each query is served on its own
by `WMDService.top_k`, the per-query program (kernels #5, #1 and #2 on the
card), after a first untimed query, and the loop ends with the mean
per-query time and queries/s.
``--prune`` serves top-k through the retrieval cascade (bound tiers, then
the exact rerank of the candidates; the same answer as the full scan) over
the whole query set in one call and prints the solves avoided.
``--coalesce-window-ms W`` (W > 0) turns the one-shot path into a serving
loop, as in the reference launcher: a `serving.coalescer.QueryCoalescer`
in front of the service micro-batches an asynchronous stream of Zipf
queries (open-loop Poisson arrivals at ``--rate-qps``, or back-to-back
submits when 0), with ``--max-queue`` backpressure and optional
per-request ``--deadline-ms`` budgets; the loop warms every shape it can
dispatch first (`serving.warmup`). Ctrl-C drains the queue and the
in-flight batch before exiting; the `ServingStats` report always prints
on the way out (and persists with ``--stats-out``). ``--resilience`` (or
``--brownout-queue``) routes dispatches through the resilience guard and
runs the serving watchdog. ``--ingest-stream N`` serves from a live
WAL-backed corpus (`data.LiveCorpus` in ``--live-dir``, seeded from the
synthetic corpus on first use and *recovered* when the directory exists)
and interleaves N seeded add / remove ops with the queries through the
coalescer's writer lane, with a compaction every ``--compact-every`` ops;
the loop ends with the count of acked write ops.
``--offline QUERIES`` runs the offline bulk-scoring mode instead: the
query file (the reference's format) streams through the engine at full
batch occupancy, top-k reranks batched across the batch (union rerank).
``--warmup`` warms the one-shot and offline paths too; ``--cache-dir DIR``
builds and looks up the CUDA kernels in DIR (`serving.warmup.
enable_compilation_cache`), so a restarted server loads them without nvcc.
Runs on the card unless ``--device cpu`` is given. The service runs on a
single-controller mesh (`launch.mesh`): ``--mesh DxM`` (data x model) or
``PxDxM`` (pod x data x model), by default (n, 1). ``--devices N`` makes
N logical devices, placed round-robin on the visible cards (all on
``cuda:0`` on a one-card machine; on the CPU with ``--device cpu``), the
counterpart of the reference's forced host device count; without it, n
is the number of visible cards (1 on the CPU). An indexed ``--device
cuda:1`` serves on that one card and takes neither flag. Several shards on
one card test the program's logic, not its speed across cards.

Any other ``--arch`` (`repro_torch.configs.arch_ids`) runs a language
model as the reference launcher does: the published config (``--smoke``:
its reduced smoke config), random parameters made on the device by a
`torch.Generator` seeded 0, ``--batch`` rows of ``--prefill-len`` random
tokens (numpy seed 0) prefilled (with random patch or frame embeddings
for the vlm / audio families), then ``--decode-steps`` greedy decode
steps with the cache donated; it prints the prefill time and the decode
time a token. It runs on one device (``--device``; the card by default),
or with ``--devices`` / ``--mesh`` on a mesh as the WMD service does: the
parameters placed by the partitioning rules (moved, a block a position),
the cache by `cache_shardings`, the batch over (pod, data) (whisper's
random frames with the tokens); every config runs on any mesh.
"""
import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4,
                    help="language model: rows of the batch")
    ap.add_argument("--prefill-len", type=int, default=64,
                    help="language model: prompt tokens a row")
    ap.add_argument("--decode-steps", type=int, default=32,
                    help="language model: greedy decode steps")
    ap.add_argument("--num-queries", type=int, default=4)
    ap.add_argument("--batch-queries", action="store_true",
                    help="serve all queries in one batched (Q, v_r, N) "
                         "solve instead of a per-query loop")
    ap.add_argument("--impl", default="kernel",
                    choices=("kernel", "fused", "unfused"),
                    help="contraction path (kernel = the CUDA kernels on "
                         "the card, their plain versions on the CPU)")
    ap.add_argument("--docs-chunk", type=int, default=0,
                    help="cache-block the batched solve over doc chunks of "
                         "this size (0 = unchunked)")
    ap.add_argument("--tol", type=float, default=0.0,
                    help="early-exit tolerance (0 = fixed max_iter)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="docs listed per query (0 = 5)")
    ap.add_argument("--prune", action="store_true",
                    help="top-k through the retrieval cascade (bound tiers "
                         "+ exact rerank; the full scan's answer) and "
                         "print the solves avoided")
    ap.add_argument("--coalesce-window-ms", type=float, default=0.0,
                    help="> 0 runs the async serving loop -- a "
                         "QueryCoalescer micro-batches a query stream "
                         "with this coalescing window (ms)")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="serving loop: Q bucket that cuts a batch on fill "
                         "(rounded up to a power of two)")
    ap.add_argument("--max-queue", type=int, default=256,
                    help="serving loop: admission-queue bound (blocking "
                         "backpressure when full; 0 = unbounded)")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="serving loop: per-request deadline budget "
                         "(0 = none); deadlines pull dispatch earlier")
    ap.add_argument("--rate-qps", type=float, default=0.0,
                    help="serving loop: open-loop Poisson arrival rate "
                         "(0 = submit back-to-back, saturating)")
    ap.add_argument("--requests", type=int, default=64,
                    help="serving loop: total queries to serve")
    ap.add_argument("--resilience", action="store_true",
                    help="serving loop: route dispatches through the "
                         "resilience layer (circuit-breaker impl ladder, "
                         "bounded retry, degraded bound-only fallback) and "
                         "run the serving watchdog (dispatcher liveness + "
                         "straggler strikes -> breaker trips)")
    ap.add_argument("--brownout-queue", type=int, default=0,
                    help="serving loop: queue depth that enters brownout "
                         "(degraded bound-only responses until the queue "
                         "clears; 0 = brownout disabled). Implies "
                         "--resilience")
    ap.add_argument("--warmup", action="store_true",
                    help="dispatch every shape of the serving envelope "
                         "(pow2 Q buckets x request kinds) once via the "
                         "shape registry before any query runs, and print "
                         "the per-shape report")
    ap.add_argument("--cache-dir", default="",
                    help="build and look up the CUDA kernels here -- a "
                         "restart loads the libraries it finds without "
                         "running nvcc")
    ap.add_argument("--offline", default="", metavar="QUERIES",
                    help="offline bulk-scoring mode -- stream this query "
                         "file (.npz/.npy, (n, V)) at maximum batch "
                         "occupancy instead of serving; with --top-k, "
                         "reranks use union batching")
    ap.add_argument("--offline-out", default="", metavar="OUT",
                    help="offline mode: write the scored outputs (npz) "
                         "here")
    ap.add_argument("--rerank", default="union",
                    choices=("union", "per_query"),
                    help="offline mode: rerank batching strategy (both "
                         "are bitwise-identical; union runs (Q, chunk) "
                         "programs instead of Q x (1, chunk))")
    ap.add_argument("--ingest-stream", type=int, default=0, metavar="N",
                    help="serving loop: build the service over a live "
                         "WAL-backed corpus and interleave N seeded "
                         "add/remove ops through the coalescer's writer "
                         "lane (requires --coalesce-window-ms)")
    ap.add_argument("--live-dir", default="",
                    help="live-corpus directory (snapshots + WAL); an "
                         "existing directory is *recovered*, so a killed "
                         "run resumes with every acked write. Default: a "
                         "fresh temp dir")
    ap.add_argument("--compact-every", type=int, default=0, metavar="OPS",
                    help="ingest mode: run an (interruptible, atomically "
                         "swapped) corpus compaction every OPS ingest ops "
                         "(0 = never)")
    ap.add_argument("--metrics-port", type=int, default=-1, metavar="PORT",
                    help="serving loop: serve the live metrics registry as "
                         "Prometheus text exposition on this port (0 = an "
                         "ephemeral port, printed at startup; -1 = off)")
    ap.add_argument("--trace-out", default="", metavar="TRACE.json",
                    help="serving loop: record per-request span trees and "
                         "write a Perfetto-loadable Chrome trace here on "
                         "exit (structured events stream to "
                         "TRACE.json.events.jsonl while serving)")
    ap.add_argument("--stats-out", default="", metavar="STATS.json",
                    help="serving loop: persist the final ServingStats + "
                         "warmup/resilience/watchdog reports as JSON on "
                         "clean exit AND on SIGINT")
    ap.add_argument("--device", default="cuda",
                    help="torch device the service runs on: a type (the "
                         "mesh's devices) or one indexed device")
    ap.add_argument("--devices", type=int, default=0,
                    help="logical devices of the mesh, round-robin on the "
                         "visible cards (0 = one a visible card)")
    ap.add_argument("--mesh", default="",
                    help="mesh shape DxM (data x model) or PxDxM; default "
                         "(devices, 1)")
    args = ap.parse_args(argv)

    if args.arch != "sinkhorn-wmd":
        _serve_lm(args, ap)
        return

    import time

    import numpy as np

    from repro_torch.configs import sinkhorn_wmd as wmd_cfg
    from repro_torch.data.corpus import make_corpus
    from repro_torch.serving import WMDService, enable_compilation_cache

    if args.cache_dir:
        # before the first kernel launch: every library from here on is
        # built in / loaded from the cache directory
        enable_compilation_cache(args.cache_dir)
    if args.ingest_stream and args.coalesce_window_ms <= 0:
        ap.error("--ingest-stream requires --coalesce-window-ms > 0 "
                 "(writes go through the coalescer's writer lane)")
    mesh = _mesh(args, ap)
    cfg = wmd_cfg.smoke_config() if args.smoke else wmd_cfg.config()
    data = make_corpus(vocab_size=cfg.vocab_size, embed_dim=cfg.embed_dim,
                       num_docs=cfg.num_docs, num_queries=args.num_queries,
                       query_words=min(cfg.v_r - 1, 19))
    if args.ingest_stream:
        import tempfile

        from repro_torch.core.formats import doc_lists_from_ell
        from repro_torch.data import LiveCorpus
        live_dir = args.live_dir or tempfile.mkdtemp(prefix="wmd-live-")
        # the corpus stores already-normalized weights (make_corpus emits
        # a normalized ELL), so segment rebuilds must not re-normalize
        live = LiveCorpus(live_dir, cfg.vocab_size, normalize=False)
        if live.num_live == 0:
            seed_docs = doc_lists_from_ell(data.ell)
            live.add_docs(list(range(len(seed_docs))), seed_docs)
            print(f"[serve-wmd] live corpus seeded: "
                  f"{live.num_live} docs at {live_dir}")
        else:
            print(f"[serve-wmd] live corpus recovered: "
                  f"{live.num_live} docs, gen {live.gen} at {live_dir}")
        svc = WMDService.from_live(mesh, cfg, data.vecs, live,
                                   impl=args.impl, tol=args.tol)
    else:
        svc = WMDService(cfg=cfg, vecs=data.vecs, ell=data.ell, mesh=mesh,
                         impl=args.impl, docs_chunk=args.docs_chunk or None,
                         tol=args.tol)
    print(f"[serve-wmd] {mesh}")
    if args.offline:
        _serve_wmd_offline(svc, args)
        return
    if args.warmup and args.coalesce_window_ms <= 0:
        _warmup_wmd(svc, args)     # the serving loop warms on its own
    if args.coalesce_window_ms > 0:
        _serve_wmd_loop(svc, cfg, args)
        return
    k = args.top_k or 5
    if args.batch_queries or args.prune:
        # first call outside timing
        svc.top_k_batch(data.queries, k, prune=args.prune)
        t0 = time.perf_counter()
        idx_b, dist_b = svc.top_k_batch(data.queries, k, prune=args.prune)
        dt = time.perf_counter() - t0
        for i in range(len(idx_b)):
            print(f"[serve-wmd] query {i}: top{k} docs {idx_b[i].tolist()} "
                  f"d={np.round(dist_b[i], 3).tolist()}")
        msg = (f"[serve-wmd] {'pruned' if args.prune else 'batched'} "
               f"Q={len(idx_b)} on {svc.device}: {dt * 1e3:.1f} ms "
               f"({len(idx_b) / dt:.1f} queries/s)")
        if args.prune:
            ps = svc.last_prune_stats
            msg += (f", solves avoided {ps['solves_avoided']:.1%} "
                    f"({ps['exact_solves']}/{ps['scan_solves']})")
        print(msg)
        return
    svc.top_k(data.queries[0], k)               # first call outside timing
    total = 0.0
    for i, r in enumerate(data.queries):
        t0 = time.perf_counter()
        idx, dist = svc.top_k(r, k)
        dt = time.perf_counter() - t0
        total += dt
        print(f"[serve-wmd] query {i}: top{k} docs {idx.tolist()} "
              f"d={np.round(dist, 3).tolist()} ({dt * 1e3:.1f} ms)")
    q = len(data.queries)
    print(f"[serve-wmd] per-query Q={q} on {svc.device}: "
          f"{total / q * 1e3:.2f} ms a query ({q / total:.1f} queries/s)")


def _serve_lm(args, ap):
    """Prefill + greedy decode of a language model (module docstring)."""
    import time

    import numpy as np
    import torch

    from repro_torch.configs import arch_ids, get_config, get_smoke_config
    from repro_torch.distributed import partitioning
    from repro_torch.launch.mesh import one_device_mesh, resolve_device
    from repro_torch.models import build_model
    from repro_torch.models.sharding_hints import activation_sharding
    from repro_torch.serving import build_serve_fns

    if args.arch not in arch_ids():
        ap.error(f"--arch {args.arch!r}: one of sinkhorn-wmd, "
                 f"{', '.join(arch_ids())}")
    mesh = _mesh(args, ap) if (args.devices or args.mesh) \
        else one_device_mesh(resolve_device(args.device))
    dev = mesh.device()
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, q_block=16, kv_block=16, device=dev)
    max_len = args.prefill_len + args.decode_steps
    prefill_for, decode_for = build_serve_fns(model, mesh, max_len=max_len)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    if mesh.size > 1:        # moved onto the mesh: a block a position
        params = partitioning.shard(
            params, partitioning.param_shardings(mesh, params))
        print(f"[serve] {cfg.name} on {mesh}")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(
        0, cfg.vocab_size, (args.batch, args.prefill_len)).astype(np.int32)}
    if cfg.family == "vlm":
        p = cfg.encoder.num_positions
        batch["patches"] = rng.normal(
            size=(args.batch, p, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        f = cfg.encoder.num_positions
        batch["frames"] = rng.normal(
            size=(args.batch, f, cfg.d_model)).astype(np.float32)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with activation_sharding(mesh, "prefill"):
        sync()
        t0 = time.perf_counter()
        logits, cache = prefill_for(args.batch)(params, batch)
        sync()
    print(f"[serve] prefill {args.prefill_len} tokens: "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    dec = decode_for(args.batch)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    with activation_sharding(mesh, "decode"):
        sync()
        t0 = time.perf_counter()
        for _ in range(args.decode_steps):
            logits, cache = dec(params, cache, tok)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        sync()
        dt = time.perf_counter() - t0
    print(f"[serve] {args.decode_steps} decode steps: {dt * 1e3:.1f} ms "
          f"({dt / max(args.decode_steps, 1) * 1e3:.2f} ms/tok) on {dev}")


def _mesh(args, ap):
    """The service's mesh from ``--device``, ``--devices`` and ``--mesh``
    (see the module docstring)."""
    from repro_torch.launch.mesh import (logical_devices, make_mesh,
                                         resolve_device)
    dev = resolve_device(args.device)
    if dev.index is not None:
        if args.devices or args.mesh:
            ap.error(f"--device {args.device} names one device; --devices "
                     f"and --mesh take the device type alone")
        return make_mesh((1, 1), ("data", "model"), devices=[dev])
    devices = logical_devices(dev, args.devices)
    n = len(devices)
    if args.mesh:
        shape = tuple(int(x) for x in args.mesh.lower().split("x"))
        if len(shape) not in (2, 3):
            ap.error(f"--mesh {args.mesh!r}: DxM or PxDxM")
        axes = ("data", "model") if len(shape) == 2 \
            else ("pod", "data", "model")
    else:
        shape, axes = (n, 1), ("data", "model")
    size = 1
    for x in shape:
        size *= x
    if size != n:
        ap.error(f"--mesh {args.mesh} has {size} positions for {n} devices")
    return make_mesh(shape, axes, devices=devices)


def _warmup_wmd(svc, args):
    """Registry warmup for the one-shot / offline paths; prints the report
    (the serving loop records the same data into ServingStats instead)."""
    ks = (args.top_k,) if args.top_k else ()
    kinds = None
    if args.offline and args.top_k:
        # the offline driver dispatches union-rerank programs, a shape the
        # online coalescer never cuts -- warm it explicitly
        kinds = ("plain", "top_k", "top_k_union")
    report = svc.warmup(max_batch=args.max_batch, ks=ks, kinds=kinds)
    print(f"[serve-wmd] warmup: {len(report.registry)} shapes in "
          f"{report.wall_s:.2f}s, {report.compiles} nvcc compiles "
          f"({report.compile_s:.2f}s), {report.persistent_hits} libraries "
          f"loaded from the build directory ({report.retrieval_s:.2f}s)")
    return report


def _report_cache_flush():
    """Print the kernel build directory's on-disk state (exit paths: normal
    return and SIGINT both land here)."""
    from repro_torch.serving import flush_compilation_cache
    info = flush_compilation_cache()
    if info:
        print(f"[serve-wmd] kernel build directory: {info['entries']} "
              f"libraries ({info['bytes'] / 1e3:.0f} kB) at {info['dir']}")


def _serve_wmd_offline(svc, args):
    """Offline bulk-scoring: query file -> full-occupancy batches -> npz."""
    from repro_torch.serving import load_query_file, run_offline
    qs = load_query_file(args.offline)
    if args.warmup:
        _warmup_wmd(svc, args)
    try:
        res = run_offline(svc, qs, k=args.top_k or None,
                          max_batch=args.max_batch, rerank=args.rerank,
                          impl=args.impl)
        msg = (f"[serve-wmd] offline {res.mode}: {res.n} queries in "
               f"{res.batches} batches of <= {res.max_batch}, "
               f"{res.wall_s:.2f}s ({res.throughput_qps:.1f} q/s)")
        if res.mode == "top_k":
            msg += f", rerank={res.rerank}"
            if res.solves_avoided is not None:
                msg += f", solves avoided {res.solves_avoided:.1%}"
            msg += f", {res.rerank_programs} rerank programs"
        print(msg)
        if args.offline_out:
            print(f"[serve-wmd] wrote {res.save(args.offline_out)}")
    finally:
        _report_cache_flush()


def _dump_serving_stats(path, st, warmup_report, guard, watchdog, svc,
                        wall_s):
    """Persist the final serving report as one JSON document.

    Called from the serving loop's ``finally`` block, so clean exit and
    SIGINT both leave the same artifact; everything in it is plain
    scalars (ServingStats asdict + the warmup / resilience / watchdog /
    live-corpus report dicts)."""
    import dataclasses
    import json
    payload = {
        "wall_s": wall_s,
        "serving": dataclasses.asdict(st),
        "warmup": warmup_report.summary() if warmup_report else None,
        "resilience": (dataclasses.asdict(guard.stats())
                       if guard is not None else None),
        "watchdog": watchdog.report() if watchdog is not None else None,
        "live_corpus": (svc.live.stats()
                        if getattr(svc, "live", None) is not None else None),
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, default=str)
    print(f"[serve-wmd] stats persisted at {path}")
    return payload


def _serve_wmd_loop(svc, cfg, args):
    """Async serving loop: Zipf stream -> QueryCoalescer -> query_batch.

    SIGINT-safe by construction: KeyboardInterrupt only breaks the submit
    loop; the ``finally`` block still drains the queue + in-flight batch
    (shutdown-with-drain) and prints the ServingStats report, so every
    accepted request is answered before the process exits.
    """
    import time

    import numpy as np

    from repro_torch.data import zipf_query_stream
    from repro_torch.serving import open_loop

    stream = zipf_query_stream(vocab_size=cfg.vocab_size,
                               query_words=min(cfg.v_r - 1, 13), seed=0)
    qs = [next(stream) for _ in range(args.requests)]
    # observability: one registry for the whole stack (service K-cache
    # counters already mirror into svc.metrics), one optional tracer
    tracer = metrics_srv = exporter = None
    if args.trace_out:
        from repro_torch.obs import JsonlExporter, Tracer
        tracer = Tracer()
        exporter = JsonlExporter(tracer, args.trace_out + ".events.jsonl")
        if getattr(svc, "live", None) is not None:
            svc.live.tracer = tracer      # WAL + compaction boundaries
    if args.metrics_port >= 0:
        from repro_torch.obs import MetricsServer
        metrics_srv = MetricsServer(svc.metrics, port=args.metrics_port)
        print(f"[serve-wmd] metrics: http://localhost:{metrics_srv.port}"
              f"/metrics")
    guard = watchdog = None
    if args.resilience or args.brownout_queue:
        from repro_torch.distributed.fault_tolerance import (FaultPolicy,
                                                             ServingWatchdog)
        from repro_torch.serving import EngineGuard, ResiliencePolicy
        policy = ResiliencePolicy(
            brownout_queue_hi=args.brownout_queue or None,
            brownout_queue_lo=max((args.brownout_queue or 0) // 4, 0))
        guard = EngineGuard(svc, policy, tracer=tracer,
                            metrics=svc.metrics)
        # dispatch-kind heartbeats: straggler strikes force-open the
        # active rung's breaker (demote); liveness is polled in `finally`
        watchdog = ServingWatchdog(
            FaultPolicy(timeout_s=30.0),
            on_strike=lambda kind: guard.trip(kind),
            tracer=tracer)
    co = svc.async_service(window_ms=args.coalesce_window_ms,
                           max_batch=args.max_batch,
                           max_queue=args.max_queue,
                           default_deadline_ms=args.deadline_ms or None,
                           resilience=guard,
                           heartbeat=watchdog.beat if watchdog else None,
                           metrics=svc.metrics,
                           tracer=tracer)
    if watchdog is not None:
        # stalled-dispatcher detection only counts silence as a stall
        # while work is actually pending
        watchdog.pending_fn = lambda: co.stats().queue_depth
    # registry warmup: one pass dispatches every shape this coalescer can
    # cut (pow2 buckets x kinds), so no live dispatch pays a first call;
    # per-shape seconds land in ServingStats
    warm_rep = co.warm_registry(ks=(args.top_k,) if args.top_k else (),
                                queries=qs)
    print(f"[serve-wmd] warmup: {len(warm_rep.registry)} shapes in "
          f"{warm_rep.wall_s:.2f}s, {warm_rep.compiles} nvcc compiles "
          f"({warm_rep.compile_s:.2f}s), {warm_rep.persistent_hits} "
          f"libraries loaded from the build directory")
    if args.top_k:
        submit = lambda r: co.submit_top_k(r, args.top_k)   # noqa: E731
    else:
        submit = co.submit
    wfuts: list = []
    if args.ingest_stream:
        # seeded writer stream: mostly upserts of fresh doc ids, some
        # removes of existing ones, paced to spread over the query stream;
        # every op goes through the coalescer's writer lane so write
        # batches interleave with (and order against) query batches
        wrng = np.random.default_rng(1)
        next_id = [svc.live.num_live]
        done = [0]
        every = max(1, args.requests // max(args.ingest_stream, 1))

        def maybe_ingest(i: int) -> None:
            if done[0] >= args.ingest_stream or i % every:
                return
            done[0] += 1
            if wrng.random() < 0.25 and next_id[0] > 0:
                victim = int(wrng.integers(0, next_id[0]))
                wfuts.append(co.submit_remove_docs([victim]))
            else:
                nw = int(wrng.integers(2, min(8, cfg.v_r)))
                wids = wrng.choice(cfg.vocab_size, size=nw, replace=False)
                cnts = wrng.integers(1, 5, size=nw).astype(np.float64)
                cnts /= cnts.sum()          # corpus stores normalized docs
                doc = [(int(w), float(c)) for w, c in zip(wids, cnts)]
                wfuts.append(co.submit_add_docs([next_id[0]], [doc]))
                next_id[0] += 1
            if args.compact_every and done[0] % args.compact_every == 0:
                svc.compact()       # interruptible; serialized vs dispatch

        base_submit = submit
        counter = [0]

        def submit(r):              # noqa: F811 -- deliberate wrap
            maybe_ingest(counter[0])
            counter[0] += 1
            return base_submit(r)
    print(f"[serve-wmd] serving loop: {args.requests} zipf queries"
          + (f" (top-{args.top_k} pruned)" if args.top_k else "") + ", "
          f"window={args.coalesce_window_ms:g} ms "
          f"max_batch={co.max_batch} max_queue={args.max_queue} "
          f"rate={'saturating' if args.rate_qps <= 0 else args.rate_qps} "
          f"on {svc.device} (Ctrl-C drains and reports)")
    futs = []
    t0 = time.perf_counter()
    try:
        if args.rate_qps > 0:
            # loadgen's open loop: absolute seeded Poisson schedule, so slow
            # submits (e.g. blocking backpressure) make the driver catch up
            # instead of silently lowering the offered rate
            open_loop(submit, qs, rate_qps=args.rate_qps, seed=0)
        else:
            futs = [submit(r) for r in qs]         # saturating back-to-back
        co.drain()
    except KeyboardInterrupt:
        print("\n[serve-wmd] SIGINT: draining queued + in-flight requests")
    finally:
        co.shutdown(drain=True)
        dt = time.perf_counter() - t0
        st = co.stats()
        if futs and futs[0].exception() is None:
            res = futs[0].result()
            if args.top_k:
                idx, d = res
            else:
                idx = np.argsort(res)[:5]
                d = res[idx]
            print(f"[serve-wmd] sample query 0: top docs {idx.tolist()} "
                  f"d={np.round(d, 3).tolist()}")
        print(f"[serve-wmd] served {st.completed}/{st.submitted} in "
              f"{dt:.2f}s ({st.completed / max(dt, 1e-9):.1f} q/s), "
              f"mean batch {st.mean_batch_size:.1f}")
        print(f"[serve-wmd] dispatches={st.dispatches} "
              f"(fill={st.dispatch_fill} window={st.dispatch_window} "
              f"deadline={st.dispatch_deadline} drain={st.dispatch_drain}) "
              f"hist={st.batch_size_hist}")
        print(f"[serve-wmd] latency ms: mean={st.latency_ms_mean:.1f} "
              f"p50={st.latency_ms_p50:.1f} p95={st.latency_ms_p95:.1f} "
              f"p99={st.latency_ms_p99:.1f} "
              f"deadline_misses={st.deadline_misses}"
              + (f" hit_rate={st.hit_rate:.2f}"
                 if st.hit_rate is not None else ""))
        if args.ingest_stream:
            acked = sum(1 for f in wfuts
                        if f.done() and f.exception() is None)
            ls = svc.live.stats()
            print(f"[serve-wmd] ingest: {acked}/{len(wfuts)} write ops "
                  f"acked over {st.write_dispatches} dispatches "
                  f"(+{st.docs_added}/-{st.docs_removed} docs), "
                  f"gen={ls['gen']} live={ls['num_live']} "
                  f"delta={ls['delta_rows']} wal={ls['wal_bytes']}B")
        if guard is not None:
            gs = guard.stats()
            stalled = watchdog.check()
            print(f"[serve-wmd] resilience: retries={gs.retries} "
                  f"demoted={gs.demoted} degraded={st.degraded} "
                  f"({st.degraded_fraction:.1%} of completed) "
                  f"quarantined={st.quarantined} "
                  f"breaker_transitions={gs.breaker_transitions} "
                  f"open_rungs={gs.breaker_open} "
                  f"brownout_entries={gs.brownout_entries}"
                  + (f" STALLED={stalled}" if stalled else ""))
            for kind, rep in watchdog.report().items():
                print(f"[serve-wmd] watchdog[{kind}]: "
                      f"{rep['dispatches']} beats, "
                      f"{rep['failures']} failures, "
                      f"{rep['tripped']} strikes tripped, "
                      f"median {rep['median_wall_s'] * 1e3:.1f} ms")
        # SIGINT lands here too: leave the final report on record
        if args.stats_out:
            _dump_serving_stats(args.stats_out, st, warm_rep, guard,
                                watchdog, svc, dt)
        if tracer is not None:
            if exporter is not None:
                exporter.close()
            tracer.export_chrome(args.trace_out)
            print(f"[serve-wmd] trace: {args.trace_out} "
                  f"({len(tracer.completed)} request trees, "
                  f"{tracer.open_count} left open) + event log at "
                  f"{args.trace_out}.events.jsonl")
        if metrics_srv is not None:
            metrics_srv.close()
        _report_cache_flush()


if __name__ == "__main__":
    main()
