"""Run one benchmark cell of the Sinkhorn-WMD port (`repro_torch`).

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up makes the corpus, the embeddings and the query pool from the seed on
the card, installs the service and warms the cell's shapes; the window then
drives the cell's traffic for ``--seconds``; afterwards the outputs sampled
from the window are compared with the plain reference. With ``--trace 1``
the run also traces a stretch of the window and reports the cell's
per-layer metrics instead of its end-to-end ones. The last line of
standard output is the result, as JSON.

A cell file with a ``"mesh"`` (``{"shape": [D, S], "axes": ["data",
"model"]}``, `cells.check_mesh`) lays the service out on that mesh of the
cell's ``chips`` cards; corpus, queries and the reference stay on its first
card. Memory, busy time and the solve's device time are read on each card
(`Cards`, `perfbench.devtime`).

Needs an NVIDIA GPU: without one it exits with status 2 and prints no
result. It refuses to print a result if the process has loaded JAX or the
JAX package.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _paths() -> None:
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    cache = ROOT / "build" / "perfbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def _config(cfg: dict):
    from repro_torch.configs.sinkhorn_wmd import WMDConfig
    return WMDConfig(name=cfg["name"], vocab_size=cfg["vocab_size"],
                     embed_dim=cfg["embed_dim"], num_docs=cfg["num_docs"],
                     nnz_max=cfg["nnz_max"], v_r=cfg["v_r"],
                     lamb=cfg["lamb"], max_iter=cfg["max_iter"])


class Cards:
    """The run's distinct cards (logical shards of one card are one card),
    whose calls are skipped on a CPU run (the tests)."""

    def __init__(self, devices):
        import torch

        from perfbench.devtime import cards_of
        self.torch = torch
        self.cards = cards_of(devices)
        self.on = self.cards[0].type == "cuda"

    def sync(self) -> None:
        if self.on:
            for c in self.cards:
                self.torch.cuda.synchronize(c)

    def peaks(self) -> list[int]:
        """Each card's peak of allocated bytes (0 on the CPU)."""
        return [int(self.torch.cuda.max_memory_allocated(c)) if self.on
                else 0 for c in self.cards]

    def empty_cache(self) -> None:
        if self.on:
            for c in self.cards:
                with self.torch.cuda.device(c):
                    self.torch.cuda.empty_cache()


def _card_works(data, cfg: dict, tr: dict, doc_devices, device) -> list:
    """(`work.solve_work`, distinct words) of one batch on each card, for
    the doc shards it holds (``doc_devices``: each doc shard's device, in
    doc order); counted on ``device``."""
    import torch

    from perfbench import work
    vocab = cfg["vocab_size"]
    held: dict = {}
    for (lo, hi), dev in zip(work.doc_shards(cfg["num_docs"],
                                             len(doc_devices)), doc_devices):
        held.setdefault(torch.device(dev), []).append((lo, hi))
    out = []
    for ranges in held.values():
        counts = sum(torch.bincount(torch.from_numpy(data.cols[lo:hi].ravel())
                                    .to(device, torch.int64),
                                    minlength=vocab + 1)
                     for lo, hi in ranges)
        distinct = int((counts[:vocab] > 0).sum())
        out.append((work.solve_work(
            words=[tr["query_words"]] * tr["batch"],
            num_docs=sum(hi - lo for lo, hi in ranges),
            nnz=sum(int(data.lengths[lo:hi].sum()) for lo, hi in ranges),
            distinct_words=distinct, max_iter=cfg["max_iter"]), distinct))
    return out


def run_cell(cell, *, seed: int, seconds: float, trace: bool,
             device: str = "cuda", devices=None, fault=None,
             control: str | None = None) -> tuple[dict, list]:
    """Run ``cell`` (a `cells.Cell`); returns (result, checks) where checks
    are (name, value, limit). A cell without a mesh runs on ``device``; one
    with a mesh on ``devices``, row major over its shape (None: the first
    ``chips`` visible cards, distinct; tests pass logical shards of one
    device). ``fault(svc)``, for tests, breaks the service after its
    set-up. ``control`` (a `reference` precision) adds the control's
    numbers on the same sample as ``result["control"]``."""
    import numpy as np
    import torch

    from perfbench import cells, compare, corpus, devtime, instrument
    from perfbench import loops, work
    from repro_torch.core.formats import EllDocs
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serving.wmd_service import WMDService

    cfg, tr, spec = cell.config, cell.traffic, cell.spec
    if cell.mesh is None:
        if devices is not None:
            raise ValueError(f"{cell.name} has no mesh to lay on devices")
        mesh, place, doc_devices = None, {"device": device}, [device]
        cu = Cards([device])
    else:
        mesh = make_mesh(*cell.mesh, devices=devices)
        device = mesh.device()
        place = {"mesh": mesh}
        # each doc shard's first device (model shard 0), in doc order
        doc_devices = list(mesh.devices.reshape(-1, mesh.shape["model"])
                           [:, 0])
        cu = Cards(list(mesh.devices.flat))
    rng = np.random.default_rng(int(seed) % (1 << 64))

    # -- set-up -------------------------------------------------------------
    t_setup = time.monotonic()
    t = time.monotonic()
    data = corpus.make_corpus(
        seed=seed, device=device, vocab_size=cfg["vocab_size"],
        embed_dim=cfg["embed_dim"], num_docs=cfg["num_docs"],
        mean_words=cfg["mean_words"], zipf_s=cfg["zipf_s"],
        nnz_align=cfg["nnz_align"])
    pool = corpus.make_queries(
        seed=seed, device=device, vocab_size=cfg["vocab_size"],
        n=tr["pool"], words=tr["query_words"], zipf_s=tr["zipf_s"])
    cu.sync()
    nnz = int(data.lengths.sum())
    log(f"[setup] generate: {time.monotonic() - t:.3f} s ({cfg['num_docs']} "
        f"docs, {nnz} nonzeros, ELL width {data.cols.shape[1]}; "
        f"{len(pool)} queries of {tr['query_words']} words)")
    t = time.monotonic()
    svc = WMDService(cfg=_config(cfg), vecs=data.vecs,
                     ell=EllDocs(cols=data.cols, vals=data.vals,
                                 num_vocab=cfg["vocab_size"]),
                     **place, **spec.get("service", {}))
    cu.sync()
    log(f"[setup] install: {time.monotonic() - t:.3f} s"
        + ("" if mesh is None else f" on {mesh!r}"))
    t = time.monotonic()
    vocab = cfg["vocab_size"]
    warm_rows = corpus.DenseRows(max(tr.get("warm_batches", [1])
                                     + [tr.get("batch", 1)]), vocab)
    tail = len(pool) - warm_rows.buf.shape[0]

    def warm_qs(n):
        return [warm_rows.put(j, pool.ids[tail + j], pool.weights[tail + j])
                for j in range(n)]

    if tr["loop"] == "closed":
        for _ in range(2):
            svc.query_batch(warm_qs(tr["batch"]))
    else:
        for b in tr["warm_batches"]:
            svc.top_k_batch(warm_qs(b), tr["k"], prune=True)
    cu.sync()
    builds = _build.build_counts()
    log(f"[setup] warm-up: {time.monotonic() - t:.3f} s; kernels: "
        f"{builds['compiles']} compiled ({builds['compile_s']:.3f} s), "
        f"{builds['loads']} loaded ({builds['load_s']:.3f} s) in "
        f"{_build.BUILD_DIR}")
    setup_s = time.monotonic() - t_setup
    log(f"[setup] total: {setup_s:.3f} s")
    if fault is not None:
        fault(svc)

    # -- window -------------------------------------------------------------
    spans = stretch = None
    stretch_at = stretch_s = 0.0
    launches0 = [0]
    if trace:
        spans = instrument.Spans()
        spans.attach(svc)
        stretch_s = min(float(tr.get("trace_seconds", 2.0)), seconds / 2)
        stretch_at = (seconds - stretch_s) / 2
        stretch = devtime.Stretch(cu.cards) if cu.on else None
        if stretch is not None:
            log(f"[trace] profiler warmed before the window: "
                f"{stretch.warm():.3f} s")

    def on_tick(elapsed):
        if stretch is None:
            return
        if stretch.t0 is None and elapsed >= stretch_at:
            launches0[0] = sum(_build.launches.values())
            stretch.start()
        elif stretch.t1 is None and stretch.t0 is not None \
                and time.monotonic() - stretch.t0 >= stretch_s:
            stretch.stop()
            launches0[0] = sum(_build.launches.values()) - launches0[0]

    kc0 = svc.cache_stats
    kc0 = (kc0.hit_rows, kc0.miss_rows)
    m = {"setup_s": setup_s, "loop": tr["loop"]}
    co = None
    if tr["loop"] == "closed":
        res = loops.closed_loop(svc, pool, vocab_size=vocab,
                                batch=tr["batch"], seconds=seconds,
                                keep=spec["sample"]["batches"], rng=rng,
                                on_tick=on_tick)
        m.update(window_s=res.window_s, queries=res.queries,
                 batches=res.batches)
        attempted, failed, missing = res.queries, 0, 0
        log(f"[window] {len(res.batches)} batches of {tr['batch']} in "
            f"{res.window_s:.3f} s")
    else:
        from repro_torch.obs.trace import Tracer
        tracer = Tracer(ring=1 << 16) if trace else None
        co = svc.async_service(tracer=tracer, **tr.get("coalescer", {}))
        res = loops.open_loop(
            lambda r: co.submit_top_k(r, tr["k"]), pool, vocab_size=vocab,
            rate_qps=tr["rate_qps"], seconds=seconds, rng=rng,
            sample=spec["sample"]["requests"], on_tick=on_tick)
        co.shutdown(drain=True)
        st = co.stats()
        ps = svc.last_prune_stats
        if ps:
            log(f"[window] last dispatch: {ps.get('queries')} queries, "
                f"solves avoided {ps.get('solves_avoided')}, rerank "
                f"programs {ps.get('rerank_programs')}, bound "
                f"{ps.get('bound_s')} s, rerank {ps.get('rerank_s')} s")
        lat = res.latency_s
        n = res.due.size
        missing = int(np.isnan(res.done).sum())
        attempted, failed = n, int(n - res.ok.sum())
        m.update(window_s=seconds, latency_s=lat, dispatches=st.dispatches,
                 dispatched=sum(q * c for q, c in st.batch_size_hist.items()))
        if tracer is not None:
            trees, _ = tracer.snapshot()
            m["dispatch_spans"] = sorted({(s["t0"], s["t1"])
                                          for tr_ in trees
                                          for s in tr_["spans"]
                                          if s["name"] == "dispatch"})
        late = res.late_s[~np.isnan(res.late_s)]
        log(f"[window] {n} requests at {tr['rate_qps']} q/s over "
            f"{seconds} s: {int(res.ok.sum())} served, {missing} never "
            f"came; p50 {np.percentile(lat, 50) * 1e3:.3f} ms, p95 "
            f"{np.percentile(lat, 95) * 1e3:.3f} ms; generator late p50 "
            f"{np.percentile(late, 50) * 1e3:.3f} ms, max "
            f"{late.max() * 1e3:.3f} ms; {st.dispatches} dispatches, "
            f"mean batch {st.mean_batch_size:.3f}")
    if stretch is not None and stretch.t1 is None and stretch.t0 is not None:
        stretch.stop()
        launches0[0] = sum(_build.launches.values()) - launches0[0]
    peaks = cu.peaks()
    log(f"[window] peak device memory by card: "
        + ", ".join(f"{c} {p}" for c, p in zip(cu.cards, peaks)))
    kc1 = svc.cache_stats
    m["kcache"] = (kc1.hit_rows - kc0[0], kc1.miss_rows - kc0[1])

    # -- traced readings ----------------------------------------------------
    breakdown = None
    dev_extra = {}
    if trace:
        # a vocabulary split over model shards has no count (`work`)
        if spans.last_solve is not None and tr["loop"] == "closed" \
                and cu.on and (mesh is None or mesh.shape["model"] == 1):
            fn, a, kw = spans.last_solve
            dev_s = devtime.device_ms(lambda: fn(*a, **kw),
                                      reps=int(tr.get("solve_reps", 3)),
                                      cards=cu.cards) / 1e3
            works = _card_works(data, cfg, tr, doc_devices, device)
            least, by, i = work.slowest([w for w, _ in works])
            w, distinct = works[i]
            m["solve"] = {"device_s": dev_s, "least_s": least}
            log(f"[trace] solve of one batch: device {dev_s * 1e3:.4f} ms "
                f"(CUDA events behind a spin), least {least * 1e3:.4f} ms "
                f"by {by} ({w['flops']:.6e} operations, {w['bytes']:.6e} "
                f"bytes, {distinct} distinct words"
                + (")" if len(works) == 1 else
                   f" on the slowest of {len(works)} cards)"))
        if stretch is not None and stretch.t1 is not None:
            hand = devtime.kernel_names(
                ROOT / "src" / "repro_torch" / "kernels" / "csrc")
            rd = devtime.read_stretch(stretch, spans.spans, hand)
            m["trace"] = rd
            log(f"[trace] stretch {rd['window_s']:.3f} s (profiler start "
                f"{stretch.start_s:.3f} s): {rd['events']} "
                f"device events; hand-kernel launches counted by the "
                f"program: {launches0[0]}, held by the trace: "
                f"{rd['hand_kernel_events']}")
            breakdown = {"device_ops": rd["device_ops"],
                         "idle_gaps": rd["idle_gaps"]}
            dev_extra = {"busy_s": rd["busy_s"], "window_s": rd["window_s"],
                         "busy_s_by_card": rd["busy_s_by_card"]}
            log(f"[trace] device busy {rd['busy_s']:.6f} s of "
                f"{rd['window_s']:.6f} s; idle share "
                f"{1 - rd['busy_s'] / rd['window_s']:.6f}"
                + ("" if len(cu.cards) == 1 else
                   f"; by card {rd['busy_s_by_card']}")
                + (f"; {rd['events_off_cards']} events on other cards"
                   if rd["events_off_cards"] else ""))

    # -- free the program's state, then the comparison ----------------------
    del svc, co, spans
    gc.collect()
    cu.empty_cache()
    t = time.monotonic()
    limits = spec["limits"]
    if tr["loop"] == "closed":
        nums = compare.bulk(res.kept, data, pool, cfg, device=device)
    else:
        nums = compare.top_k(res.results, res.pool_rows, data, pool, cfg,
                             device=device, k=tr["k"])
    cu.sync()
    log(f"[check] reference over the sample: {time.monotonic() - t:.3f} s")
    ctl = None
    if control is not None:
        if tr["loop"] == "closed":
            ctl = compare.bulk(res.kept, data, pool, cfg, device=device,
                               precision=control, control=True)
        else:
            ctl = compare.top_k(res.results, res.pool_rows, data, pool, cfg,
                                device=device, k=tr["k"], precision=control,
                                control=True)
    checks = [(k, nums[k], limits[k]) for k in limits]
    correct = all(v <= lim for _, v, lim in checks) and missing == 0
    # a number that could not be read (no sample) fails, and is printed
    # as null: JSON has no infinity
    checks = [(k, v if math.isfinite(v) else None, lim)
              for k, v, lim in checks]

    # -- metrics ------------------------------------------------------------
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for spec_m in wanted:
        v = cells.reader(spec_m["name"])(m)
        if v is not None:
            metrics[spec_m["name"]] = {"value": v, "unit": spec_m["unit"]}
    result = {
        "correct": bool(correct), "attempted": int(attempted),
        "failed": int(failed), "metrics": metrics,
        "device": {"platform": "gpu" if cu.on else "cpu",
                   "kind": (torch.cuda.get_device_name(cu.cards[0])
                            if cu.on else "cpu"),
                   "count": len(cu.cards), "memory_peak_bytes": max(peaks),
                   "memory_peak_bytes_by_card": peaks, **dev_extra},
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    if ctl is not None:
        result["control"] = ctl
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, v, lim in checks}
    return result, checks


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _paths()
    from perfbench import cells
    cell = cells.load(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"perfbench: the cell needs {cell.chips} CUDA device(s); "
            f"found {torch.cuda.device_count()} (cuda available: "
            f"{torch.cuda.is_available()})")
        return 2
    result, checks = run_cell(cell, seed=args.seed, seconds=args.seconds,
                              trace=bool(args.trace))
    bad = forbidden_modules()
    if bad:
        log(f"perfbench: the process loaded {', '.join(bad)}")
        return 3
    for name, v, lim in checks:
        log(f"[check] {name} {v!r} limit {lim!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
