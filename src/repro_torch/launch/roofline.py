"""Roofline report: three terms per (arch x shape x mesh) from dry-run JSON.

    PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh pod16x16]

Port of `repro.launch.roofline`, with the constants of the NVIDIA H100
SXM (NVIDIA H100 Tensor Core GPU datasheet, SXM5 column):

  compute    = FLOPs / (chips * peak)     bf16 dense tensor cores 989.4e12
                                          flop/s (the datasheet's 1,979
                                          TFLOPS is with 2:4 sparsity);
                                          fp32 (CUDA cores) 67e12 for the
                                          sinkhorn-wmd cells, whose kernels
                                          are fp32 CUDA-core code
  memory     = HBM bytes / (chips * 3.35e12 B/s)
  collective = wire bytes / (chips * 450e9 B/s)   NVLink: 900 GB/s in
                                          total, 450e9 a direction

Scoping (`costmodel`): every count of the port is GLOBAL, the sum over the
mesh's positions, the collectives' wire bytes too, so each term divides by
chips (the reference counts its sinkhorn-wmd shard_map and its HLO
collectives per device and divides those by nothing).

MODEL_FLOPS = 6*N*D for train (N = active params for MoE), 2*N*D for
prefill, 2*N*B for decode (one token), the reference's rule. The "useful
fraction" is MODEL_FLOPS / counted FLOPs; the roofline fraction is
model-flops-time / dominant term.

Writes experiments/roofline_torch_<mesh>.md and prints the table.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

PEAK_FLOPS = 989.4e12        # bf16 dense tensor cores / chip
PEAK_FLOPS_FP32 = 67e12      # fp32 outside the tensor cores / chip
HBM_BW = 3.35e12             # bytes/s / chip
LINK_BW = 450e9              # bytes/s / chip, one direction of NVLink

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments")


def model_flops(arch: str, shape: str) -> float:
    from repro_torch.configs import get_config, get_shape
    if arch == "sinkhorn-wmd":
        from repro_torch.configs import sinkhorn_wmd as wmd_cfg
        cfg = wmd_cfg.config(shape[:-4] if shape.endswith("_opt")
                             else shape)
        # cdist (2*v_r*V*w) + t iterations of 2 fused contractions over nnz
        nnz = cfg.num_docs * 35                   # corpus mean words/doc
        return (2.0 * cfg.v_r * cfg.vocab_size * cfg.embed_dim
                + cfg.max_iter * 2 * 2 * nnz * cfg.v_r)
    cfg = get_config(arch)
    sh = get_shape(shape)
    n = cfg.active_param_count()
    if sh.kind == "train":
        return 6.0 * n * sh.global_batch * sh.seq_len
    if sh.kind == "prefill":
        return 2.0 * n * sh.global_batch * sh.seq_len
    return 2.0 * n * sh.global_batch              # decode: one token


def chips(mesh_name: str) -> int:
    return 512 if "2x16x16" in mesh_name else 256


def peak_flops(arch: str) -> float:
    """The compute term's peak: fp32 CUDA cores for the WMD cells, the
    bf16 tensor cores for the language models."""
    return PEAK_FLOPS_FP32 if arch == "sinkhorn-wmd" else PEAK_FLOPS


def terms(flops: float, bytes_: float, collective_bytes: float = 0.0, *,
          peak: float = PEAK_FLOPS, n_chips: float = 1.0) -> dict:
    """The roofline's three terms in seconds: ``flops`` over ``n_chips``
    at ``peak``, ``bytes_`` at the HBM rate, ``collective_bytes`` at the
    link rate. The largest is the least time the work can take."""
    return {"compute": flops / n_chips / peak,
            "memory": bytes_ / n_chips / HBM_BW,
            "collective": collective_bytes / n_chips / LINK_BW}


def analyze_cell(rec: dict) -> dict | None:
    if rec.get("status") != "ok":
        return None
    mesh_name = rec["mesh"]
    n_chips = float(chips(mesh_name))
    jc = rec.get("jaxpr_cost") or {}
    flops = jc.get("flops", 0.0)
    peak = peak_flops(rec["arch"])
    coll = rec.get("collectives") or {}
    t = terms(flops, jc.get("bytes", 0.0), float(coll.get("total", 0.0)),
              peak=peak, n_chips=n_chips)
    bottleneck = max(t, key=t.get)
    mf = model_flops(rec["arch"], rec["shape"])
    t_model = mf / n_chips / peak
    useful = mf / flops if flops else 0.0
    dominant = max(t.values())
    frac = t_model / dominant if dominant > 0 else 0.0
    mem_gib = ((rec.get("memory_analysis") or {})
               .get("temp_size_in_bytes") or 0) / 2 ** 30
    return {"arch": rec["arch"], "shape": rec["shape"], "mesh": mesh_name,
            **{f"t_{k}": v for k, v in t.items()},
            "bottleneck": bottleneck, "useful_flops_frac": useful,
            "roofline_frac": frac, "temp_gib_per_chip": mem_gib,
            "unknown_loops": jc.get("unknown_loops", 0)}


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x * 1e6:.1f}us"
    if x < 1:
        return f"{x * 1e3:.2f}ms"
    return f"{x:.2f}s"


def row(r: dict) -> str:
    """One cell's line of the table."""
    return (f"| {r['arch']} | {r['shape']} | {fmt_s(r['t_compute'])} | "
            f"{fmt_s(r['t_memory'])} | {fmt_s(r['t_collective'])} | "
            f"**{r['bottleneck']}** | {r['useful_flops_frac']:.2f} | "
            f"{r['roofline_frac']:.2f} | {r['temp_gib_per_chip']:.2f} |")


def report(mesh_name: str, dryrun_dir: str | None = None) -> str:
    dryrun_dir = dryrun_dir or os.path.join(OUT_DIR, "dryrun_torch",
                                            mesh_name)
    rows, skips = [], []
    for f in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(f) as fh:
            rec = json.load(fh)
        if rec.get("status") == "skipped":
            skips.append((rec["arch"], rec["shape"], rec.get("reason", "")))
            continue
        r = analyze_cell(rec)
        if r:
            rows.append(r)
    lines = [
        f"### Roofline -- {mesh_name} ({chips(mesh_name)} chips, "
        "H100 SXM: 989.4 TF/s bf16 (67 TF/s fp32 for sinkhorn-wmd), "
        "3.35 TB/s HBM, 450 GB/s NVLink a direction)",
        "",
        "| arch | shape | compute | memory | collective | bottleneck | "
        "useful FLOPs | roofline frac | temp GiB/chip |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        lines.append(row(r))
    if skips:
        lines += ["", "Skipped cells:", ""]
        for a, s, why in skips:
            lines.append(f"* {a} x {s}: {why}")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="pod16x16",
                    choices=["pod16x16", "pod2x16x16"])
    args = ap.parse_args(argv)
    txt = report(args.mesh)
    out = os.path.join(OUT_DIR, f"roofline_torch_{args.mesh}.md")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(out, "w") as f:
        f.write(txt + "\n")
    print(txt)
    print(f"\nwritten: {out}")


if __name__ == "__main__":
    main()
