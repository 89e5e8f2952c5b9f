"""Smoke run of the PyTorch / CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line is printed):

  1. the card: name and power limit (nvidia-smi), torch / CUDA versions;
  2. build: every CUDA source under src/repro_torch/kernels/csrc, one nvcc
     per source, all started together; build seconds and ptxas's register,
     shared-memory and spill report;
  3. the main path at sinkhorn-wmd/paper_5k (V = 100,000, w = 300,
     N = 5,000, v_r bucket 32, 15 iterations; `make_corpus(seed=0)`):
     `WMDService(device="cuda", cache_capacity=1024)` with its defaults
     (impl="kernel", kexp_impl="kernel") answers two Zipf batches of
     Q = 16 (19 words a query); the kernels' launch counts, read around
     exactly those two calls, must be 15 type1 and 1 type2 launches per
     batch and one cdist_kexp_rows launch per 128-row miss chunk;
  4. correctness of what came out: the same batches through the plain
     engine on the same K rows (impl="fused"), through the all-plain route
     (impl="fused", kexp_impl="jnp"), cache on == use_cache=False bitwise,
     the legacy route (cache off), and the dense oracle
     `sinkhorn_wmd_dense` on a 64-doc slice (see `_compare` for the
     tolerances of routes whose K rows come from another spelling);
  5. each kernel against its plain PyTorch version at the main path's
     shapes, with its time (CUDA events), the plain version's time, a
     library yardstick where one exists, and the bound: the larger of the
     bytes the function must move over 3.35 TB/s and its fp32 operations
     over 67 TFLOP/s (H100 SXM data sheet, 700 W).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""
import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12         # H100 SXM HBM3
FP32_FLOPS_PER_S = 67e12          # H100 SXM fp32 outside the tensor cores
TOL_ENGINE = dict(rtol=2e-3, atol=1e-5)   # the reference's engine tolerance
TOL_KERNEL = dict(rtol=1e-4, atol=1e-6)   # same math, sums reassociated
TOL_SELF_RTOL = 5e-3       # pairs that gather a word's own column: _compare


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def _timed(fn, reps: int, warmup: int = 2) -> float:
    """Milliseconds per call from CUDA events around ``reps`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _shares_word(batch, ell):
    """(Q, N) mask: doc j holds one of query q's words."""
    import numpy as np
    live = ell.vals != 0
    return np.stack([(np.isin(ell.cols, np.nonzero(r)[0]) & live).any(axis=1)
                     for r in batch])


def _compare(what, got, want, share):
    """Hold distances computed from two spellings of the K rows together.

    The matmul expansion |a|^2 + |b|^2 - 2ab cancels on a word's own column
    (|a|^2 ~ 500 at w = 300): the plain spelling (cuBLAS product, separate
    norms) leaves M(i, i) at fp32 round-off, up to ~2.5e-2, where the CUDA
    kernel gets exactly 0 (its norms and dot products run one fma chain).
    Only a (query, doc) pair whose doc holds one of the query's words
    gathers such a column, and 15 iterations amplify the difference to a
    few 1e-3 of the distance: those pairs are held to rtol 5e-3, every
    other pair to the engine tolerance rtol 2e-3, atol 1e-5."""
    import numpy as np
    rel = np.abs(got - want) / np.abs(want)
    print(f"[check] {what}: max rel {rel[~share].max(initial=0.0):.3g} "
          f"over {int((~share).sum())} pairs sharing no word (rtol 2e-3), "
          f"{rel[share].max(initial=0.0):.3g} over {int(share.sum())} "
          f"pairs sharing one (rtol {TOL_SELF_RTOL:g})")
    np.testing.assert_allclose(got[~share], want[~share], **TOL_ENGINE)
    np.testing.assert_allclose(got[share], want[share], rtol=TOL_SELF_RTOL,
                               atol=1e-5)


def _ptxas_summary(log: str) -> list[str]:
    keep = ("Compiling entry", "Used", "spill")
    return [ln.strip() for ln in log.splitlines()
            if any(k in ln for k in keep)]


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (precision pins)
    from repro_torch.configs.sinkhorn_wmd import config
    from repro_torch.core import sparse_sinkhorn as ss
    from repro_torch.core.sinkhorn import select_query, sinkhorn_wmd_dense
    from repro_torch.data.corpus import make_corpus, zipf_query_stream
    from repro_torch.kernels import _build, kexp, ops, sddmm_spmm
    from repro_torch.serving import WMDService

    dev = torch.device("cuda")

    # -- 1. the card ----------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f"[card] {torch.cuda.get_device_name(0)}, torch {torch.__version__}"
          f", CUDA {torch.version.cuda}, devices {torch.cuda.device_count()}")

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    seconds = _build.build()
    print(f"[build] {time.perf_counter() - t0:.1f} s wall, per source "
          + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()))
    for name, log in _build.ptxas_log.items():
        for ln in _ptxas_summary(log):
            print(f"[ptxas {name}] {ln}")

    # -- 3. the main path -------------------------------------------------------
    cfg = config("paper_5k")
    t0 = time.perf_counter()
    data = make_corpus(vocab_size=cfg.vocab_size, embed_dim=cfg.embed_dim,
                       num_docs=cfg.num_docs, num_queries=1, seed=0)
    stream = zipf_query_stream(vocab_size=cfg.vocab_size, query_words=19,
                               seed=1)
    batch1 = [next(stream) for _ in range(16)]
    batch2 = [next(stream) for _ in range(16)]
    print(f"[data] paper_5k corpus: V {cfg.vocab_size}, w {cfg.embed_dim}, "
          f"N {data.ell.num_docs}, nnz_max {data.ell.nnz_max}, nnz "
          f"{data.ell.nnz}; {time.perf_counter() - t0:.1f} s on the host")
    svc = WMDService(cfg=cfg, vecs=data.vecs, ell=data.ell,
                     cache_capacity=1024)
    _check(svc.device.type == "cuda" and svc.impl == "kernel"
           and svc.kexp_impl == "kernel", "service defaults changed")
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    d1 = svc.query_batch(batch1)
    t1 = time.perf_counter()
    stats1 = dict(svc.last_batch_stats)
    d2 = svc.query_batch(batch2)
    t2 = time.perf_counter()
    stats2 = dict(svc.last_batch_stats)
    launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated()
    chunks = sum(math.ceil(s["misses"] / svc.cache_rows_bucket)
                 for s in (stats1, stats2))
    want = {"sddmm_spmm_type1_batch": 2 * cfg.max_iter,
            "sddmm_spmm_type2_batch": 2, "cdist_kexp_rows": chunks}
    print(f"[main] launches {launches}, expected {want}")
    _check(launches == want, f"launch counts {launches} != {want}")
    _check(all(v > 0 for v in launches.values()), "a kernel never launched")
    for i, (s, dt) in enumerate(((stats1, t1 - t0), (stats2, t2 - t1))):
        print(f"[main] batch {i + 1}: Q=16 in {dt * 1e3:.1f} ms "
              f"({16 / dt:.1f} queries/s); precompute_s "
              f"{s['precompute_s']:.4f}, solve_s {s['solve_s']:.4f}, "
              f"unique {s['unique']}, misses {s['misses']}, hit_rate "
              f"{s['hit_rate']:.3f}")
    print(f"[main] peak device memory {peak / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated)")

    # -- 4. correctness of the output ----------------------------------------
    for d in (d1, d2):
        _check(d.shape == (16, cfg.num_docs) and np.isfinite(d).all()
               and (d > 0).all(), "distances not finite and positive")
    same_rows = WMDService(cfg=cfg, vecs=data.vecs, ell=data.ell,
                           cache_capacity=1024, impl="fused")
    plain = WMDService(cfg=cfg, vecs=data.vecs, ell=data.ell,
                       cache_capacity=1024, impl="fused", kexp_impl="jnp")
    for i, (d, batch) in enumerate(((d1, batch1), (d2, batch2))):
        b = same_rows.query_batch(batch)
        print(f"[check] batch {i + 1}, kernels vs plain engine (impl fused) "
              f"on the same K rows: max rel "
              f"{float((np.abs(d - b) / b).max()):.3g}, held to rtol 2e-3 "
              f"atol 1e-5")
        np.testing.assert_allclose(d, b, **TOL_ENGINE)
        _compare(f"batch {i + 1}, kernel route vs all-plain route (impl "
                 f"fused, kexp_impl jnp)", d, plain.query_batch(batch),
                 _shares_word(batch, data.ell))
    again = svc.query_batch(batch1)
    off = svc.query_batch(batch1, use_cache=False)
    _check(np.array_equal(again, d1) and np.array_equal(off, d1),
           "cache on / hits / use_cache=False not bitwise equal")
    print("[check] cache hits == first call == use_cache=False: bitwise")
    legacy = WMDService(cfg=cfg, vecs=data.vecs, ell=data.ell,
                        cache_capacity=0)
    d_leg = legacy.query_batch(batch1)
    _check(legacy.last_batch_stats["route"] == "legacy_fused",
           "legacy route not taken")
    _compare("legacy route (in-solve matmul precompute) vs stripes route",
             d_leg, d1, _shares_word(batch1, data.ell))
    docs = 64
    c = torch.zeros((cfg.vocab_size + 1, docs), device=dev)
    cols = torch.from_numpy(data.ell.cols[:docs]).long().to(dev)
    vals = torch.from_numpy(data.ell.vals[:docs]).to(dev)
    c[cols, torch.arange(docs, device=dev)[:, None].expand_as(cols)] = vals
    c = c[:cfg.vocab_size]
    vecs_d = svc._vecs_d
    dense = np.stack([sinkhorn_wmd_dense(
        *(torch.from_numpy(x).to(dev) for x in select_query(batch1[i])), c,
        vecs_d, cfg.lamb, cfg.max_iter).cpu().numpy() for i in range(3)])
    _compare(f"dense oracle on {docs} docs x 3 queries", d1[:3, :docs],
             dense, _shares_word(batch1[:3], data.ell)[:, :docs])

    # -- 5. the kernels at the main path's shapes ------------------------------
    sel_b, r_b, mask_b = svc._padded_query_batch(batch1)
    k_s, km_s, _ = svc._kcache.stripes_for_batch(sel_b, mask_b)
    k_pad, km_pad = k_s[0], km_s[0]
    r = torch.from_numpy(r_b).to(dev)
    cols, vals = svc._cols_d[0], svc._vals_d[0]
    q, v_r, n, nnz = 16, cfg.v_r, cols.shape[0], cols.shape[1]
    x = torch.full((q, v_r, n), 1.0 / v_r, device=dev)
    for _ in range(3):                        # a realistic iterate
        x = ops.sddmm_spmm_type1_batch(k_pad, r, ss.safe_recip(x), cols,
                                       vals)
    u = ss.safe_recip(x)
    live = vals != 0
    nnz_real = int(live.sum())
    uniq = int(torch.unique(cols[live]).numel())
    print(f"[kernels] Q {q}, v_r {v_r}, V+1 {k_pad.shape[-1]}, N {n}, "
          f"nnz_max {nnz}, nonzero slots {nnz_real}, distinct words {uniq}")
    results = []

    def record(name, source, replaces, got, want, kernel_fn, plain_fn,
               nbytes, flops, library_fn=None, plain_reps=3):
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        ms = _timed(kernel_fn, 20)
        plain_ms = _timed(plain_fn, plain_reps, warmup=1)
        lib_ms = _timed(library_fn, 10) if library_fn else None
        bound_ms, bound_by = _bound(nbytes, flops)
        results.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": lib_ms})
        print(f"[kernels] {name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library {lib_ms if lib_ms is None else f'{lib_ms:.4f}'} ms,"
              f" bound {bound_ms:.4f} ms ({bound_by}), max abs err "
              f"{err:.3g}")

    src = "src/repro_torch/kernels/csrc/sddmm_spmm.cu"
    x_k = sddmm_spmm.sddmm_spmm_type1_batch(k_pad, r, u, cols, vals)
    x_p = sddmm_spmm.sddmm_spmm_type1_batch_plain(k_pad, r, u, cols, vals)
    torch.cuda.synchronize()
    torch.testing.assert_close(x_k, x_p, **TOL_KERNEL)
    rows = q * v_r
    record("sddmm_spmm_type1_batch", src,
           "src/repro/kernels/sddmm_spmm.py:239", [x_k], [x_p],
           lambda: sddmm_spmm.sddmm_spmm_type1_batch(k_pad, r, u, cols,
                                                     vals),
           lambda: sddmm_spmm.sddmm_spmm_type1_batch_plain(k_pad, r, u, cols,
                                                           vals),
           nbytes=4 * (rows * uniq + rows + 2 * rows * n + 2 * n * nnz),
           flops=q * nnz_real * (4 * v_r + 1) + rows * n)
    del x_k, x_p
    d_k = sddmm_spmm.sddmm_spmm_type2_batch(k_pad, km_pad, u, cols, vals)
    d_p = sddmm_spmm.sddmm_spmm_type2_batch_plain(k_pad, km_pad, u, cols,
                                                  vals)
    torch.cuda.synchronize()
    torch.testing.assert_close(d_k, d_p, **TOL_KERNEL)
    record("sddmm_spmm_type2_batch", src,
           "src/repro/kernels/sddmm_spmm.py:272", [d_k], [d_p],
           lambda: sddmm_spmm.sddmm_spmm_type2_batch(k_pad, km_pad, u, cols,
                                                     vals),
           lambda: sddmm_spmm.sddmm_spmm_type2_batch_plain(k_pad, km_pad, u,
                                                           cols, vals),
           nbytes=4 * (2 * rows * uniq + rows * n + 2 * n * nnz + q * n),
           flops=q * nnz_real * (4 * v_r + 1) + 2 * rows * n)
    del d_k, d_p, k_s, km_s, x, u
    m, w, v = 128, cfg.embed_dim, cfg.vocab_size
    ids = torch.from_numpy(np.unique(sel_b)[:m].astype(np.int64)).to(dev)
    a = vecs_d[ids].contiguous()
    k_k, km_k = kexp.cdist_kexp_rows(a, vecs_d, lamb=cfg.lamb)
    k_p, km_p = kexp.cdist_kexp_rows_plain(a, vecs_d, lamb=cfg.lamb)
    torch.cuda.synchronize()
    # a row against its own word: |a|^2 + |b|^2 - 2ab cancels (|a|^2 ~ 500
    # at w = 300); the plain spelling keeps round-off there (M(i, i) up to
    # ~2.5e-2 instead of 0), the kernel cancels exactly (see kexp.cu), so K
    # there is held to an absolute 5e-2; off the diagonal only the
    # reassociated dot products differ
    near = (km_p / k_p) < 1.0
    _check(bool(((k_k - k_p).abs()[near] <= 5e-2).all()),
           "cdist_kexp_rows: K near the diagonal off by more than 5e-2")
    torch.testing.assert_close(k_k[~near], k_p[~near], rtol=1e-3, atol=0.0)
    torch.testing.assert_close(km_k[~near], km_p[~near], rtol=1e-3,
                               atol=0.0)
    print(f"[kernels] cdist_kexp_rows: {int(near.sum())} near-diagonal "
          f"entries (abs 5e-2), the rest rtol 1e-3; largest M there: "
          f"kernel {float((km_k / k_k)[near].max()):.3g}, plain "
          f"{float((km_p / k_p)[near].max()):.3g}")
    record("cdist_kexp_rows", "src/repro_torch/kernels/csrc/kexp.cu",
           "src/repro/kernels/kexp.py:93", [k_k, km_k], [k_p, km_p],
           lambda: kexp.cdist_kexp_rows(a, vecs_d, lamb=cfg.lamb),
           lambda: kexp.cdist_kexp_rows_plain(a, vecs_d, lamb=cfg.lamb),
           nbytes=4 * (m * w + v * w + 2 * m * v),
           flops=2 * m * v * w + 2 * (m + v) * w + 8 * m * v,
           library_fn=lambda: torch.cdist(a, vecs_d), plain_reps=10)

    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    print(f"[card] after the run: {clocks.stdout.strip()}")
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
