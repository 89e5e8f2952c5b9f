"""How far a mesh moves one float32 train step's gradients, on one NVIDIA
GPU.

    python3 scripts/mesh_moments.py [--arch xlstm-125m] [--meshes 2x1,1x2,2x2]

Builds ``--arch`` as published (``get_config``, float32 compute) with
`chip_smoke.py` phase 16(b)'s step (batch 8 x 128 of
``TokenPipeline(seed=0)``, AdamW warmup_cosine(3e-4, 1, 10), parameters
from a `torch.Generator` seeded 0) and takes one step on 1 x 1 and on each
mesh of logical shards of ``cuda:0``. After one step the first moment is
0.1 x the gradient, so a mesh's first moments against the 1 x 1 ones say
how far its sums' order moves the gradient. Prints the card's name and
power limit, then for each mesh the loss and grad_norm's relative
differences and the six leaves (index in flatten order, shape) whose
first moments differ most, relative to the leaf's largest |moment| and to
the largest of all leaves. A (2, 1) mesh changes only the order in which
the two batch groups' gradients are summed.
"""
import argparse
import dataclasses
import gc
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--meshes", default="2x1,1x2,2x2")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import chip_smoke as cs
    from repro_torch import _tree
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import init_state

    if not torch.cuda.is_available():
        raise SystemExit("mesh_moments: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(args.arch), compute_dtype="float32")
    model = build_model(cfg, device=dev)
    opt = adamw(warmup_cosine(3e-4, warmup_steps=1,
                              total_steps=cs.TRAIN_STEPS))
    batch = TokenPipeline(cfg, batch=cs.TRAIN_B, seq_len=cs.TRAIN_T,
                          seed=0).batch_at(0)

    def fresh():
        return init_state(model, opt,
                          torch.Generator(device=dev).manual_seed(0))

    m1, s1, _, _ = cs._phase15_step(model, opt, None, batch, fresh, 1)
    mu1 = list(_tree.leaves(s1.opt.mu))
    top = max(float(x.abs().max()) for x in mu1)
    del s1
    for text in args.meshes.split(","):
        shape = tuple(int(x) for x in text.split("x"))
        mm, sm, _, _ = cs._phase15_step(model, opt, cs._lm_mesh(shape),
                                        batch, fresh, 1)
        rows = []
        for i, (a, b) in enumerate(zip(cs._logical_leaves(sm.opt.mu), mu1,
                                       strict=True)):
            d, mx = float((a - b).abs().max()), float(b.abs().max())
            rows.append((d / max(mx, 1e-30), i, tuple(b.shape), mx / top,
                         d / top))
        rows.sort(reverse=True)
        lrel = abs(mm[0]["loss"] - m1[0]["loss"]) / abs(m1[0]["loss"])
        grel = abs(mm[0]["grad_norm"] - m1[0]["grad_norm"]) \
            / abs(m1[0]["grad_norm"])
        print(f"{shape}: loss relative {lrel:.3g}, grad_norm relative "
              f"{grel:.3g}")
        for rel, i, shp, share, d in rows[:6]:
            print(f"   leaf {i} {shp}: {rel:.3g} of the leaf's largest "
                  f"(the leaf's largest {share:.3g} of all leaves'; the "
                  f"difference {d:.3g} of it)")
        del sm
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
