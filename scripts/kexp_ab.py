"""A/B of the cost-row kernels of ``csrc/kexp.cu`` between this tree and
another checkout of the repository, on one NVIDIA GPU.

    python3 scripts/kexp_ab.py [--other DIR] [--reps 20]

Builds ``src/repro_torch/kernels/csrc/kexp.cu`` of this tree and, with
``--other``, of DIR (with this tree's nvcc flags), loads both with ctypes
(their C entries ``cdist_kexp_rows``, ``cdist_kexp`` and ``cdist_rows``
take the same arguments) and runs them on the same inputs: the
``paper_5k`` vocabulary of ``make_corpus(seed=0)`` (V = 100,000, w = 300);
#6 ``cdist_kexp_rows`` and #7 ``cdist_rows`` on the 128 rows of
``chip_smoke.py`` phase 5 (the first 128 distinct words of batch 1 of
``zipf_query_stream(seed=1)``); #5 ``cdist_kexp`` on batch 1 query 0's
v_r = 32 rows (pad rows on word 0). It prints the sha256 of every output
of each tree, holds this tree's outputs to ``cost_rows_naive`` bitwise,
and times each kernel in turns (other, this, this, other): CUDA-event ms a
launch over ``--reps`` launches, and device ms a launch from a
torch.profiler trace. The card's name and power limit come first, then
ptxas's registers and spills of both builds.
"""
import argparse
import ctypes
import hashlib
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


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
        print("kexp_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (precision pins)
    from repro_torch.configs.sinkhorn_wmd import config
    from repro_torch.core.distributed import pad_query, pad_query_batch
    from repro_torch.core.sinkhorn import select_query
    from repro_torch.data import make_corpus, zipf_query_stream
    from repro_torch.kernels import _build, kexp
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])

    trees = {"this": None}
    procs = {}
    if args.other is not None:
        src = args.other / "src/repro_torch/kernels/csrc/kexp.cu"
        out = _build.BUILD_DIR / "libkexp-other.so"
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs["other"] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    _build.build(("kexp",))
    trees["this"] = _build.library("kexp")
    logs = {"this": _build.ptxas_log.get("kexp", "")}
    for name, (proc, out) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            print(logs[name], file=sys.stderr)
            return 1
        trees[name] = ctypes.CDLL(str(out))
    for name, log in logs.items():
        for ln in log.splitlines():
            if "Compiling entry" in ln or "Used" in ln or "spill" in ln:
                print(f"[ptxas {name}] {ln.strip()}")
    kexp_args = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_void_p]
    dist_args = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    for lib in trees.values():
        for fn, at in (("cdist_kexp_rows", kexp_args),
                       ("cdist_kexp", kexp_args), ("cdist_rows", dist_args)):
            getattr(lib, fn).argtypes = at
            getattr(lib, fn).restype = ctypes.c_int

    cfg = config("paper_5k")
    data = make_corpus(vocab_size=cfg.vocab_size, embed_dim=cfg.embed_dim,
                       num_docs=cfg.num_docs, num_queries=1, seed=0)
    stream = zipf_query_stream(vocab_size=cfg.vocab_size, query_words=19,
                               seed=1)
    batch1 = [next(stream) for _ in range(16)]
    dev = torch.device("cuda")
    vecs = torch.as_tensor(data.vecs, dtype=torch.float32, device=dev)
    sels, rsels = zip(*[select_query(r) for r in batch1])
    sel_b = pad_query_batch(sels, rsels, cfg.v_r)[0]
    rows = vecs[torch.from_numpy(np.unique(sel_b)[:128].astype(np.int64))
                .to(dev)].contiguous()
    sel0 = pad_query(*select_query(batch1[0]), cfg.v_r)[0]
    query = vecs[torch.from_numpy(sel0.astype(np.int64)).to(dev)].contiguous()
    v, w, lamb = vecs.shape[0], vecs.shape[1], float(cfg.lamb)
    stream_ptr = torch.cuda.current_stream().cuda_stream

    def runner(lib, kernel, a):
        outs = [torch.empty((a.shape[0], v), device=dev)
                for _ in range(1 if kernel == "cdist_rows" else 2)]
        fn = getattr(lib, kernel)
        if kernel == "cdist_rows":
            call_args = (a.data_ptr(), vecs.data_ptr(), outs[0].data_ptr(),
                         a.shape[0], v, w, 0, stream_ptr)
        else:
            call_args = (a.data_ptr(), vecs.data_ptr(), outs[0].data_ptr(),
                         outs[1].data_ptr(), a.shape[0], v, w, lamb,
                         stream_ptr)

        def call():
            err = fn(*call_args)
            if err:
                raise RuntimeError(f"{kernel}: cudaError {err}")
        return call, outs

    def event_ms(call):
        for _ in range(2):
            call()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            call()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / args.reps

    def device_ms(call):
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                call()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
        return total / 1e3 / args.reps if total > 0 else float("nan")

    cases = (("#6 cdist_kexp_rows", "cdist_kexp_rows", rows, "kexp"),
             ("#5 cdist_kexp", "cdist_kexp", query, "kexp"),
             ("#7 cdist", "cdist_rows", rows, "dist"))
    ok = True
    for label, kernel, a, epi in cases:
        want = kexp.cost_rows_naive(a, vecs, epilogue=epi, lamb=lamb)
        hashes = {}
        for tree, lib in trees.items():
            call, outs = runner(lib, kernel, a)
            call()
            torch.cuda.synchronize()
            hashes[tree] = [_sha(o) for o in outs]
            if tree == "this":
                same = all(torch.equal(o, x) for o, x in zip(outs, want))
                ok &= same
                print(f"[oracle] {label} ({a.shape[0]} rows): this tree "
                      f"{'==' if same else '!='} cost_rows_naive bitwise")
        for tree, hs in hashes.items():
            print(f"[sha256] {label} {tree}: {' '.join(hs)}")
        if "other" in hashes:
            same = hashes["other"] == hashes["this"]
            print(f"[sha256] {label}: the two trees' outputs are "
                  f"{'the same' if same else 'DIFFERENT'}")
        turns = ["other", "this", "this", "other"] if "other" in trees \
            else ["this", "this"]
        for tree in turns:
            call, _ = runner(trees[tree], kernel, a)
            print(f"[time] {label} {tree}: {event_ms(call):.4f} ms events, "
                  f"{device_ms(call):.4f} ms device")
    occ = kexp.occupancy()
    print("[occupancy] this tree: " + ", ".join(
        f"{k} {b} blocks/SM, {s} B dynamic shared" for k, (b, s)
        in occ.items()))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
