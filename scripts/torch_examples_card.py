"""Time the PyTorch / CUDA port's examples on one NVIDIA card.

    python3 scripts/torch_examples_card.py [--steps 300] [--reps 5] \\
        [--out build/examples_card.json]

Runs each example's `main(argv)` in this process, its printed lines echoed
with a prefix, and prints one JSON line a run (all of them also written to
``--out``), each beside the card's name and power limit (nvidia-smi):

- `examples/torch_train_moe_sinkhorn.py` at ``--steps`` (its default 300)
  with each router, on a new temporary ``--ckpt-dir`` (checkpoints every
  100 steps, removed after): the first and last loss, ms a step (the
  trainer's host clock around each step, which ends by reading the loss:
  median and mean), tokens/s from the median step, the peak device memory
  (torch.cuda.max_memory_allocated) and the run's seconds;
- `examples/torch_wmd_query_service.py` in each mode (chip_smoke.py's
  SERVICE_MODES), ``--reps`` runs each: queries/s and latency p50 / p95.
  The latencies are each request's where the example times requests (the
  default mode's `top_k` calls after the first, the coalescer's clients,
  the Zipf stream's batches), else each run's timed call (a batch; the
  offline mode times none, so its latency is not measured). Queries/s is
  the median over the runs of the example's own figure.

The examples build the kernels at their first launch; the first run of
each mode is timed like the others, after the warm call the example makes.
"""
import argparse
import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
from chip_smoke import SERVICE_MODES, _example  # noqa: E402


def _run(name, argv):
    """(return value, seconds) of the example's `main(argv)`, its printed
    lines echoed as ``[<name>]``."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            out = _example(name).main(argv)
    finally:
        for ln in buf.getvalue().splitlines():
            print(f"[{name}] {ln}")
    return out, time.perf_counter() - t0


def _train(router, steps, card):
    import torch
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--router", router, "--steps", str(steps), "--ckpt-dir",
                os.path.join(tmp, "ckpt")]
        out, secs = _run("train_moe_sinkhorn", argv)
    hist = out["history"]
    sec = np.array([h["sec"] for h in hist])
    tokens = 8 * 256                          # the example's batch x seq-len
    return {"run": f"train {router}", "steps": len(hist),
            "first_loss": hist[0]["loss"], "last_loss": hist[-1]["loss"],
            "step_ms_median": float(np.median(sec) * 1e3),
            "step_ms_mean": float(sec.mean() * 1e3),
            "first_step_ms": float(sec[0] * 1e3),
            "tokens_per_s": tokens / float(np.median(sec)),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "stragglers": out["stragglers"], "run_s": secs, "card": card}


def _service(mode, argv, reps, card):
    qps, lat = [], []
    for _ in range(reps):
        out, _ = _run("wmd_query_service", argv)
        kind = out["mode"]
        if kind == "top_k_3":
            lat += out["latency_ms"].tolist()
            qps.append(len(out["latency_ms"]) * 1e3
                       / out["latency_ms"].sum())
        elif kind == "batch_queries":
            q = len(out["dists"])
            lat.append(out["batched_s"] * 1e3)
            qps.append(q / out["batched_s"])
        elif kind == "zipf_stream":
            times = [b["precompute_s"] + b["solve_s"] for b in out["batches"]]
            lat += [t * 1e3 for t in times]
            qps.append(out["q"] * len(times) / sum(times))
        elif kind == "coalesce":
            lat += out["loadgen"].latencies_ms.tolist()
            qps.append(out["loadgen"].throughput_qps)
        elif kind == "top_k":
            lat.append(out["seconds"] * 1e3)
            qps.append(len(out["idx"]) / out["seconds"])
        else:                                 # offline
            qps.append(out["offline"].throughput_qps)
    return {"run": f"service {mode}", "argv": argv, "reps": reps,
            "qps_median": float(np.median(qps)), "qps": qps,
            "latency_ms_p50": float(np.percentile(lat, 50)) if lat else None,
            "latency_ms_p95": float(np.percentile(lat, 95)) if lat else None,
            "latencies": len(lat), "card": card}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "examples_card.json"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_examples_card: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"[card] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    rows = []
    for mode, mode_argv in SERVICE_MODES:
        rows.append(_service(mode, mode_argv, args.reps, card))
        print(json.dumps(rows[-1]))
    for router in ("sinkhorn", "topk"):
        rows.append(_train(router, args.steps, card))
        print(json.dumps(rows[-1]))
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(args.out).write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
