"""Serving launcher for the port: the Sinkhorn-WMD query service.

    python -m repro_torch.launch.serve --arch sinkhorn-wmd [--smoke]
        [--batch-queries] [--num-queries N] [--impl kernel|fused|unfused]
        [--docs-chunk D] [--tol T] [--top-k K] [--prune]
        [--device cuda|cpu]

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
Runs on the card unless ``--device cpu`` is given. The language-model
architectures of the reference launcher are not ported yet.
"""
import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
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
    ap.add_argument("--device", default="cuda",
                    help="torch device the service runs on")
    args = ap.parse_args(argv)

    if args.arch != "sinkhorn-wmd":
        ap.error(f"--arch {args.arch!r}: only sinkhorn-wmd is ported "
                 f"(the LM substrate is ROADMAP Queue 1, last item)")

    import time

    import numpy as np

    from repro_torch.configs import sinkhorn_wmd as wmd_cfg
    from repro_torch.data.corpus import make_corpus
    from repro_torch.serving import WMDService

    cfg = wmd_cfg.smoke_config() if args.smoke else wmd_cfg.config()
    data = make_corpus(vocab_size=cfg.vocab_size, embed_dim=cfg.embed_dim,
                       num_docs=cfg.num_docs, num_queries=args.num_queries,
                       query_words=min(cfg.v_r - 1, 19))
    svc = WMDService(cfg=cfg, vecs=data.vecs, ell=data.ell,
                     device=args.device, impl=args.impl,
                     docs_chunk=args.docs_chunk or None, tol=args.tol)
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


if __name__ == "__main__":
    main()
