"""Readings for the limits of ``correct``: the program's numbers on sound
runs and the control's (the reference computed in TF32, put in the
program's place) on the same sampled outputs, at the cell's own size and
load, several seeds in one process.

    python3 perfbench/calibrate.py --workload <cell> --seconds 3 \
        --seeds 11 12 13 [--control-seeds 11 12 13]

Prints one JSON line a seed and, last, the largest program reading and the
smallest control reading of each number.
"""
from __future__ import annotations

import argparse
import json
import sys

import run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=())
    args = p.parse_args(argv)
    run._paths()
    import torch
    from perfbench import cells
    if not torch.cuda.is_available():
        run.log("calibrate: needs a CUDA device")
        return 2
    cell = cells.load(args.workload)
    lower: dict = {}
    upper: dict = {}
    for seed in args.seeds:
        ctl = "tf32" if seed in args.control_seeds else None
        res, checks = run.run_cell(cell, seed=seed, seconds=args.seconds,
                                   trace=False, control=ctl)
        line = {"seed": seed, "program": {k: v for k, v, _ in checks},
                "control": res.get("control"),
                "metrics": res["metrics"]}
        print(json.dumps(line), flush=True)
        for k, v, _ in checks:
            lower[k] = max(lower.get(k, 0.0), v)
        for k, v in (res.get("control") or {}).items():
            upper[k] = min(upper.get(k, float("inf")), v)
    print(json.dumps({"lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
