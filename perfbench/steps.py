"""The program's own step spans over a benchmark cell.

    python3 perfbench/steps.py --workload <cell> --seeds <n>[,<n>...] \
        --seconds <s> --trace <0|1> --tracer <0|1|both> [--bits] \
        [--out <file>]

Each seed runs the cell as `run.py` does (`run.run_cell`: the same set-up,
window, traced stretch and comparison). With ``--tracer 1`` a
`repro_torch.obs.Tracer` is bound as the service's ``tracer`` after set-up,
so every batch of the window records its tree of host steps (`WMDService`'s
step spans); ``--tracer both`` runs each seed without and then with it, in
alternating order, to price the tracer. Per run it prints a JSON line:
run.py's metrics, ``correct``, and from the trees the mean ms a batch of
each step and the readings of `READINGS`. In a traced run on the card it
adds the stretch's idle gaps labelled by the program's spans beside the
harness's labels (`devtime.read_stretch`'s rule), and how many
`type1_vm_kernel` device events lie inside a ``solve`` span. ``--bits``
first checks, at the cell's shapes, that a bound tracer changes no bit of
`query_batch` rows or of pruned `top_k_batch` answers.

Needs an NVIDIA GPU, as run.py does.
"""
from __future__ import annotations

import argparse
import bisect
import collections
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]

# reading name -> the step names it sums, mean ms a batch
READINGS = {
    "validate_ms": ("validate",),
    "select_pad_ms": ("select_pad",),
    "guard_ms": ("km_guard", "distance_guard"),
    "d2h_ms": ("d2h",),
}
# harness gap labels (`instrument.SERVICE_SPANS`) that lie on the host path
HOST_LABELS = ("query_batch", "precompute: K cache")


def batch_steps(trees, op: str = "query_batch") -> list[dict]:
    """Per closed ``ok`` tree of ``op``: the seconds of each step name
    (summed over its spans), of the root (``batch``) and of the root's own
    time, which no step covers (``other``)."""
    from perfbench.devtime import merge
    out = []
    for t in trees:
        if t["attrs"].get("op") != op or t["status"] != "ok":
            continue
        rec = {"batch": t["t1"] - t["t0"]}
        for s in t["spans"]:
            rec[s["name"]] = rec.get(s["name"], 0.0) + s["t1"] - s["t0"]
        covered = merge((s["t0"], s["t1"]) for s in t["spans"])
        rec["other"] = rec["batch"] - sum(e - s for s, e in covered)
        out.append(rec)
    return out


def readings(steps: list[dict]) -> dict:
    """`READINGS`, ``batch_other_ms`` (the root's own time) and
    ``batch_ms``, each the mean ms a batch; empty without batches."""
    if not steps:
        return {}
    n = len(steps)
    out = {name: sum(r.get(k, 0.0) for r in steps for k in keys) / n * 1e3
           for name, keys in READINGS.items()}
    out["batch_other_ms"] = sum(r["other"] for r in steps) / n * 1e3
    out["batch_ms"] = sum(r["batch"] for r in steps) / n * 1e3
    return out


def step_means(steps: list[dict]) -> dict:
    """Mean ms a batch of every step name seen."""
    names = sorted({k for r in steps for k in r})
    return {k: sum(r.get(k, 0.0) for r in steps) / len(steps) * 1e3
            for k in names} if steps else {}


def program_spans(trees) -> list[tuple[str, float, float]]:
    """(label, t0, t1) of every tree's root (``<op> (root)``) and steps,
    the form `devtime.read_stretch` labels gaps with: a step starts after
    its root, so a gap inside a step takes the step's name."""
    out = []
    for t in trees:
        if t["t1"] is None:
            continue
        out.append((f"{t['attrs'].get('op')} (root)", t["t0"], t["t1"]))
        out.extend((s["name"], s["t0"], s["t1"]) for s in t["spans"])
    return out


def idle_gaps(stretch) -> list[tuple[float, float]]:
    """The stretch's idle gaps, as `devtime.read_stretch` finds them."""
    from perfbench.devtime import busy_and_gaps
    return busy_and_gaps(stretch.device_events(), stretch.card_ids,
                         stretch.t0, stretch.t1)[1]


def label(gaps, spans) -> list[str]:
    """Each gap's label by `devtime.read_stretch`'s rule: the latest-starting
    span that covers the gap's middle, "client" where none does."""
    spans = sorted(spans, key=lambda x: x[1])
    out = []
    for gs, ge in gaps:
        mid = (gs + ge) / 2
        lab = "client"
        for name, s, e in spans:
            if s > mid:
                break
            if e >= mid:
                lab = name
        out.append(lab)
    return out


def gap_table(gaps, harness_spans, prog_spans) -> dict:
    """Idle seconds by (harness label, program label), and the share of the
    idle time the harness puts on the host path (`HOST_LABELS` and every
    ``host: *`` label) that the program puts in a step, not a root."""
    by = collections.Counter()
    host = in_step = 0.0
    for (gs, ge), h, p in zip(gaps, label(gaps, harness_spans),
                              label(gaps, prog_spans)):
        by[(h, p)] += ge - gs
        if h in HOST_LABELS or h.startswith("host: "):
            host += ge - gs
            if p != "client" and not p.endswith(" (root)"):
                in_step += ge - gs
    return {"by_label": [[h, p, s] for (h, p), s in by.most_common()],
            "host_idle_s": host, "host_idle_in_steps_s": in_step}


def solve_cover(events, trees, kernel: str = "type1_vm_kernel"
                ) -> tuple[int, int]:
    """(held, seen): of the device events whose name holds ``kernel``, how
    many lie wholly inside one ``solve`` span."""
    solves = sorted((s["t0"], s["t1"]) for t in trees for s in t["spans"]
                    if s["name"] == "solve")
    starts = [a for a, _ in solves]
    seen = held = 0
    for name, s, e, _ in events:
        if kernel not in name:
            continue
        seen += 1
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and e <= solves[i][1]:
            held += 1
    return held, seen


def record_cost_us(n: int = 2000) -> float:
    """Microseconds a bulk batch's tree costs to record on this host: one
    root and the stripes route's seven steps with their attrs, through a
    `Tracer` with the benchmark's ring."""
    from repro_torch.obs.trace import Tracer
    tr = Tracer(ring=1 << 16)
    steps = (("validate", {"queries": 64, "bytes": 25_600_000}),
             ("select_pad", {"pad_rows": 0}),
             ("kcache", {"hits": 200, "misses": 500, "unique": 700}),
             ("km_guard", {}), ("solve", {"iters": 15}),
             ("d2h", {"bytes": 1_280_000}), ("distance_guard", {}))
    t = time.perf_counter()
    for i in range(n):
        seq = f"batch-{i}"
        tr.begin_request(seq, op="query_batch", q=64, q_pad=64)
        for name, attrs in steps:
            t0 = tr.now()
            tr.add_span(seq, name, t0, tr.now(), **attrs)
        tr.end_request(seq, route="stripes")
    return (time.perf_counter() - t) / n * 1e6


def check_bits(cell, seed: int, device: str = "cuda",
               top_k_queries: int = 4) -> dict:
    """Tracer off against on, one service at the cell's shapes: a batch of
    the cell's `query_batch` rows and a pruned top-10 of
    ``top_k_queries`` of its queries, compared bit for bit."""
    import numpy as np

    from perfbench import corpus, run
    from repro_torch.core.formats import EllDocs
    from repro_torch.obs.trace import NULL_TRACER, Tracer
    from repro_torch.serving.wmd_service import WMDService

    cfg, tr, spec = cell.config, cell.traffic, cell.spec
    data = corpus.make_corpus(
        seed=seed, device=device, vocab_size=cfg["vocab_size"],
        embed_dim=cfg["embed_dim"], num_docs=cfg["num_docs"],
        mean_words=cfg["mean_words"], zipf_s=cfg["zipf_s"],
        nnz_align=cfg["nnz_align"])
    pool = corpus.make_queries(
        seed=seed, device=device, vocab_size=cfg["vocab_size"],
        n=tr["batch"], words=tr["query_words"], zipf_s=tr["zipf_s"])
    svc = WMDService(cfg=run._config(cfg), vecs=data.vecs,
                     ell=EllDocs(cols=data.cols, vals=data.vals,
                                 num_vocab=cfg["vocab_size"]),
                     device=device, **spec.get("service", {}))
    rows = corpus.DenseRows(tr["batch"], cfg["vocab_size"])
    rs = [rows.put(j, pool.ids[j], pool.weights[j])
          for j in range(tr["batch"])]
    kq = rs[:top_k_queries]
    out = {}
    for on in (False, True):
        tracer = Tracer() if on else NULL_TRACER
        svc.tracer = tracer
        out[on] = (svc.query_batch(rs), svc.top_k_batch(kq, 10, prune=True))
        if on:
            trees = tracer.snapshot()[0]
    (d0, (i0, k0)), (d1, (i1, k1)) = out[False], out[True]
    return {"rows_bitwise": bool(np.array_equal(d0, d1)),
            "topk_bitwise": bool(np.array_equal(i0, i1)
                                 and np.array_equal(k0, k1)),
            "rows_shape": list(d0.shape), "topk_queries": len(kq),
            "trees": [[t["attrs"]["op"], t["attrs"]["route"],
                       len(t["spans"])] for t in trees]}


def run_one(cell, *, seed: int, seconds: float, trace: bool, tracer: bool,
            device: str = "cuda") -> dict:
    """One run of ``cell`` through `run.run_cell`, the tracer bound after
    set-up if ``tracer``; returns run.py's result with ``steps`` added."""
    from perfbench import devtime, run
    from repro_torch.obs.trace import Tracer

    tr = Tracer(ring=1 << 16) if tracer else None
    seen = {}
    read_stretch = devtime.read_stretch

    def keep_stretch(stretch, spans, hand, top=10):
        seen.update(stretch=stretch, harness=list(spans))
        return read_stretch(stretch, spans, hand, top)

    devtime.read_stretch = keep_stretch
    try:
        result, _ = run.run_cell(
            cell, seed=seed, seconds=seconds, trace=trace, device=device,
            fault=(lambda svc: setattr(svc, "tracer", tr)) if tr else None)
    finally:
        devtime.read_stretch = read_stretch
    result["seed"], result["tracer"] = seed, bool(tracer)
    if tr is None:
        return result
    trees, _ = tr.snapshot()
    steps = batch_steps(trees)
    result["steps"] = {"batches": len(steps), "dropped": tr.dropped,
                       "readings": readings(steps),
                       "step_ms": step_means(steps)}
    if "stretch" in seen:
        st = seen["stretch"]
        prog = program_spans(trees)
        gaps = idle_gaps(st)
        held, n = solve_cover(st.device_events(), trees)
        result["steps"].update(
            gaps=gap_table(gaps, seen["harness"], prog),
            program_idle_gaps=read_stretch(st, prog, [])["idle_gaps"],
            type1_in_solve=[held, n])
    return result


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds, one run each")
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--tracer", choices=("0", "1", "both"), default="1")
    p.add_argument("--bits", action="store_true")
    p.add_argument("--out", default=None, help="also append the lines here")
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from perfbench import cells, run
    run._paths()
    cell = cells.load(args.workload)
    import torch
    if not torch.cuda.is_available():
        run.log("perfbench/steps.py: needs a CUDA device")
        return 2
    lines = [{"card": _card(), "torch": torch.__version__,
              "workload": args.workload,
              "record_cost_us": record_cost_us()}]
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.bits:
        lines.append({"bits": check_bits(cell, seeds[0])})
        torch.cuda.empty_cache()
    for i, seed in enumerate(seeds):
        order = {"0": [False], "1": [True],
                 "both": [False, True] if i % 2 == 0 else [True, False]}
        for on in order[args.tracer]:
            lines.append(run_one(cell, seed=seed, seconds=args.seconds,
                                 trace=bool(args.trace), tracer=on))
            print(json.dumps(lines[-1]), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    print(json.dumps(lines[0]), flush=True)
    if args.bits:
        print(json.dumps(lines[1]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
