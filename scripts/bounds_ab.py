"""A/B of kernels #2 (`sddmm_spmm_type2`) and #8 (`rwmd_bound_batch`)
between this tree and another checkout of the repository, on one NVIDIA
GPU, and the timings that set #8's route threshold.

    python3 scripts/bounds_ab.py [--other DIR] [--reps 20]

Builds ``csrc/sddmm_spmm.cu`` and ``csrc/rwmd.cu`` of this tree and, with
``--other``, of DIR (with this tree's nvcc flags, into libraries of their
own under ``build/repro_torch``), loads them with ctypes and runs them on
the same ``paper_5k`` inputs (``make_corpus(seed=0)``,
batch 1 of ``zipf_query_stream(seed=1)``, as ``chip_smoke.py`` phase 5
makes them with this tree's code):

  * #2 on batch 1 query 0's v_r = 32 stripes and a realistic iterate
    (three #1 iterations). A tree whose C entry ``sddmm_spmm_type2`` reads
    the reference layout (it has no ``sddmm_spmm_type2_naive``) gets the
    stripes, one that reads vocab-major copies gets the copies; this tree
    is also timed with its two copies in the call;
  * #8 on the 16 queries' M stripes, at tier 2's 256 documents (the
    cascade's subset) and at all 5,000 (the bounds tier). A tree whose C
    entry ``rwmd_bound_batch`` takes no scratch (it has no
    ``rwmd_column_min``) runs its one kernel, at docs_blk 8 at tier 2 and
    256 at all N (the blocks the service gave it); this tree runs the route
    its shapes pick, at its default doc tile (``BOUND_DOCS_BLK``).

It prints the sha256 of each output of each tree, holds this tree's #2 to
its reference-layout oracle ``sddmm_spmm_type2_naive`` and both of its #8
routes to #9 bitwise, and times each case in turns (other, this, this,
other): CUDA-event ms a launch over ``--reps`` launches and device ms a
launch from a torch.profiler trace. Then, this tree only: both routes of
#8 at the cascade's first 256, 1,024, 1,536, 2,048 and all 5,000 documents
and docs_blk 4, 8 and 16 (device ms), the timings behind
``kernels.rwmd.DENSE_SLOTS_PER_COLUMN`` and ``BOUND_DOCS_BLK``. The card's
name and power limit come first, then ptxas's registers and spills of
every build.
"""
import argparse
import ctypes
import hashlib
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCES = ("sddmm_spmm", "rwmd")


def _sha(t) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=pathlib.Path, default=None,
                    help="root of another checkout to compare with")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("bounds_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (precision pins)
    from repro_torch.configs.sinkhorn_wmd import config
    from repro_torch.core import sparse_sinkhorn as ss
    from repro_torch.core.cascade import min_cost_vectors
    from repro_torch.core.distributed import pad_query
    from repro_torch.core.sinkhorn import select_query
    from repro_torch.data import make_corpus, zipf_query_stream
    from repro_torch.kernels import _build, kexp, lcrwmd, ops
    from repro_torch.kernels import rwmd as krwmd
    from repro_torch.kernels import sddmm_spmm
    from repro_torch.serving import WMDService
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])

    # -- build both trees (ptxas reports every time), one nvcc per source,
    # all started together --------------------------------------------------
    roots = {"this": ROOT}
    if args.other is not None:
        roots["other"] = args.other
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tree, root in roots.items():
        for name in SOURCES:
            src = root / f"src/repro_torch/kernels/csrc/{name}.cu"
            out = _build.BUILD_DIR / f"lib{name}-ab-{tree}.so"
            procs[(tree, name)] = (subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                out)
    libs, logs = {}, {}
    for (tree, name), (proc, out) in procs.items():
        logs[(tree, name)], _ = proc.communicate()
        if proc.returncode != 0:
            print(logs[(tree, name)], file=sys.stderr)
            return 1
        libs.setdefault(tree, {})[name] = ctypes.CDLL(str(out))
    for (tree, name), log in logs.items():
        for ln in log.splitlines():
            if "Compiling entry" in ln or "Used" in ln or "spill" in ln:
                print(f"[ptxas {tree} {name}] {ln.strip()}")

    def fn(tree, source, entry, argtypes):
        f = getattr(libs[tree][source], entry)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        return f

    def has(tree, source, entry):
        return hasattr(libs[tree][source], entry)

    # -- the inputs (chip_smoke.py phase 5) -----------------------------------
    cfg = config("paper_5k")
    data = make_corpus(vocab_size=cfg.vocab_size, embed_dim=cfg.embed_dim,
                       num_docs=cfg.num_docs, num_queries=1, seed=0)
    stream = zipf_query_stream(vocab_size=cfg.vocab_size, query_words=19,
                               seed=1)
    batch1 = [next(stream) for _ in range(16)]
    dev = torch.device("cuda")
    svc = WMDService(cfg=cfg, vecs=data.vecs, ell=data.ell,
                     cache_capacity=1024, mcache_capacity=1024)
    vecs = svc._vecs_d
    cols, vals = svc._cols_d[0, 0], svc._vals_d[0, 0]
    n, nnz, v_r = cols.shape[0], cols.shape[1], cfg.v_r
    sel_p, r_p, mask_p = pad_query(*select_query(batch1[0]), v_r)
    a1 = vecs[torch.from_numpy(sel_p.astype(np.int64)).to(dev)]
    k5, km5 = kexp.cdist_kexp(a1, vecs, lamb=cfg.lamb)
    mask_t = torch.from_numpy(mask_p).to(dev)[:, None]
    k1, km1 = ss.pad_k(k5 * mask_t), ss.pad_k(km5 * mask_t)
    r1 = torch.from_numpy(r_p).to(dev)
    x1 = torch.full((v_r, n), 1.0 / v_r, device=dev)
    for _ in range(3):                        # a realistic iterate
        x1 = ops.sddmm_spmm_type1(k1, r1, ss.safe_recip(x1), cols, vals)
    u1 = ss.safe_recip(x1)
    k1_vm = sddmm_spmm.k_vocab_major(k1[None])[0]
    km1_vm = sddmm_spmm.k_vocab_major(km1[None])[0]
    vp1 = k1.shape[1]
    sel_b, r_b, mask_b = svc._padded_query_batch(batch1)
    m_pad, _ = svc._mcache.m_stripes_for_batch(sel_b, mask_b)
    _, tiers = svc._cascade_bounds(sel_b, r_b, mask_b)
    key = np.maximum(tiers[0]["bounds"], tiers[1]["bounds"]).min(axis=0)
    order = torch.from_numpy(np.argsort(key, kind="stable")).to(dev)
    cols_e, vals_e = svc._ell_cols_d, svc._ell_vals_d
    q = m_pad.shape[0]

    def doc_subset(count):
        sub = torch.sort(order[:count]).values
        return cols_e[sub].contiguous(), vals_e[sub].contiguous()

    stream_ptr = torch.cuda.current_stream().cuda_stream
    ptr = ctypes.c_void_p
    t2_args = [ptr] * 6 + [ctypes.c_int] * 5 + [ptr]

    def type2_runner(tree, docs_blk):
        """#2 of ``tree`` on the layout its entry reads."""
        out = torch.empty((n,), device=dev)
        vm = has(tree, "sddmm_spmm", "sddmm_spmm_type2_naive")
        k, km = (k1_vm, km1_vm) if vm else (k1, km1)
        f = fn(tree, "sddmm_spmm", "sddmm_spmm_type2", t2_args)
        call_args = (k.data_ptr(), km.data_ptr(), u1.data_ptr(),
                     cols.data_ptr(), vals.data_ptr(), out.data_ptr(), v_r,
                     vp1, n, nnz, docs_blk, stream_ptr)

        def call():
            err = f(*call_args)
            if err:
                raise RuntimeError(f"{tree} sddmm_spmm_type2: cudaError "
                                   f"{err}")
        return call, out

    def rwmd_runner(tree, c, v, docs_blk):
        """#8 of ``tree``: the route its entry takes at these shapes."""
        out = torch.empty((q, c.shape[0]), device=dev)
        sizes = (q, v_r, vp1, c.shape[0], c.shape[1], docs_blk, stream_ptr)
        scratch = None
        if has(tree, "rwmd", "rwmd_column_min"):
            route = krwmd.rwmd_route(c.shape[0], c.shape[1], vp1)
            scratch = (torch.empty((vp1, q), device=dev)
                       if route == "dense" else None)
            f = fn(tree, "rwmd", "rwmd_bound_batch",
                   [ptr] * 5 + [ctypes.c_int] * 6 + [ptr])
            call_args = (m_pad.data_ptr(), c.data_ptr(), v.data_ptr(),
                         out.data_ptr(),
                         None if scratch is None else scratch.data_ptr(),
                         *sizes)
        else:
            f = fn(tree, "rwmd", "rwmd_bound_batch",
                   [ptr] * 4 + [ctypes.c_int] * 6 + [ptr])
            call_args = (m_pad.data_ptr(), c.data_ptr(), v.data_ptr(),
                         out.data_ptr(), *sizes)

        def call():
            err = f(*call_args)
            if err:
                raise RuntimeError(f"{tree} rwmd_bound_batch: cudaError "
                                   f"{err}")
        call.scratch = scratch                # alive as long as the call
        return call, out

    def event_ms(call, reps=None):
        reps = reps or args.reps
        for _ in range(2):
            call()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            call()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    def device_ms(call, reps=None):
        reps = reps or args.reps
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
        return total / 1e3 / reps if total > 0 else float("nan")

    # -- the checks of this tree ---------------------------------------------
    ok = True
    oracle = sddmm_spmm.sddmm_spmm_type2_naive(k1, km1, u1, cols, vals)
    c_s, v_s = doc_subset(4 * svc.prune_chunk)
    minm = min_cost_vectors(m_pad)
    lc = {"tier 2": lcrwmd.lc_rwmd_bound_batch(minm, c_s, v_s),
          "all N": lcrwmd.lc_rwmd_bound_batch(minm, cols_e, vals_e)}

    qdb = sddmm_spmm.QUERY_DOCS_BLK
    cases = [("#2 sddmm_spmm_type2", {
        "this": lambda: type2_runner("this", qdb),
        "other": lambda: type2_runner("other", 8)},
        oracle, "sddmm_spmm_type2_naive")]
    for label, (c, v), other_blk in (("tier 2", (c_s, v_s), 8),
                                     ("all N", (cols_e, vals_e), 256)):
        cases.append((f"#8 rwmd_bound_batch, {label} ({c.shape[0]} docs, "
                      f"route {krwmd.rwmd_route(*c.shape, vp1)})", {
                          "this": lambda c=c, v=v: rwmd_runner(
                              "this", c, v, krwmd.BOUND_DOCS_BLK),
                          "other": lambda c=c, v=v, b=other_blk: rwmd_runner(
                              "other", c, v, b)},
                      lc[label], "lc_rwmd_bound_batch (#9)"))
    trees = [t for t in ("this", "other") if t in libs]
    for label, runners, want, want_name in cases:
        hashes = {}
        for tree in trees:
            call, out = runners[tree]()
            call()
            torch.cuda.synchronize()
            hashes[tree] = _sha(out)
            if tree == "this":
                same = torch.equal(out, want)
                ok &= same
                print(f"[oracle] {label}: this tree "
                      f"{'==' if same else '!='} {want_name} bitwise")
        for tree, h in hashes.items():
            print(f"[sha256] {label} {tree}: {h}")
        if "other" in hashes:
            same = hashes["other"] == hashes["this"]
            print(f"[sha256] {label}: the two trees' outputs are "
                  f"{'the same' if same else 'DIFFERENT'}")
        turns = ["other", "this", "this", "other"] if "other" in libs \
            else ["this", "this"]
        for tree in turns:
            call, _ = runners[tree]()
            print(f"[time] {label} {tree}: {event_ms(call):.4f} ms events, "
                  f"{device_ms(call):.4f} ms device")
    def with_copies():
        return sddmm_spmm.sddmm_spmm_type2(k1, km1, u1, cols, vals)

    print(f"[time] #2 this, with its two copies (the reference-layout "
          f"entry): {event_ms(with_copies):.4f} ms events, "
          f"{device_ms(with_copies):.4f} ms device")

    # -- #8's routes by document count and docs_blk (this tree) ---------------
    for count in (256, 1024, 1536, 2048, cols_e.shape[0]):
        c, v = doc_subset(count)
        live = int((v != 0).sum())
        outs = {}
        for route in ("dense", "gather"):
            cells = []
            for blk in (4, 8, 16):
                def call(route=route, blk=blk):
                    return krwmd.rwmd_bound_batch_route(m_pad, c, v, route,
                                                        docs_blk=blk)
                outs[(route, blk)] = call()
                cells.append(f"docs_blk {blk}: {device_ms(call):.4f}")
            print(f"[route] {count} docs (N nnz / (V+1) = "
                  f"{count * c.shape[1] / vp1:.3f}, {live} live slots), "
                  f"{route}: device ms " + ", ".join(cells)
                  + f"; rwmd_route picks {krwmd.rwmd_route(*c.shape, vp1)}")
        torch.cuda.synchronize()
        first = next(iter(outs.values()))
        same = all(torch.equal(o, first) for o in outs.values())
        ok &= same
        print(f"[route] {count} docs: both routes at every docs_blk "
              f"{'bitwise equal' if same else 'DIFFER'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
