"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Port of `repro.launch.train`: the fault-tolerant trainer on a
single-controller mesh (`launch.mesh`). ``--mesh DxM`` (data x model) or
``PxDxM`` (pod x data x model), by default (n, 1); ``--devices N`` makes N
logical devices, placed round-robin on the visible cards (all on
``cuda:0`` on a one-card machine; on the CPU with ``--device cpu``), the
counterpart of the reference's forced host device count; without it, one
device. The parameters and moments are placed by the partitioning rules
(FSDP over ``data``, TP over ``model``, replicated over ``pod``) and the
batch over (pod, data); every config runs on any mesh. ``--smoke`` uses
the reduced config. A rerun with the same
``--ckpt-dir`` resumes from its latest checkpoint (``[trainer] restoring
step N``), on whatever mesh it runs. The checkpoint directory defaults to
``repro_torch_ckpt`` under the temporary directory.

    python -m repro_torch.launch.train --arch gemma-2b --smoke --steps 4 \\
        --ckpt-every 2 --batch 2 --seq-len 32 --device cpu
    python -m repro_torch.launch.train --arch gemma-2b --smoke --steps 4 \\
        --batch 4 --seq-len 32 --devices 4 --mesh 2x2 --device cpu
"""
import argparse
import os
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--router", choices=["topk", "sinkhorn"], default=None,
                    help="MoE router override (sinkhorn = paper technique)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--devices", type=int, default=0,
                    help="logical devices of the mesh, round-robin on the "
                         "visible cards (or the CPU)")
    ap.add_argument("--mesh", default="",
                    help="mesh shape DxM (data x model) or PxDxM; default "
                         "(devices, 1)")
    ap.add_argument("--device", default="cuda",
                    help="torch device type to train on (the card by "
                         "default), or one indexed device")
    args = ap.parse_args(argv)

    import dataclasses

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.mesh import one_device_mesh, resolve_device
    from repro_torch.launch.serve import _mesh
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import Trainer

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.router and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, router=args.router))

    mesh = _mesh(args, ap) if (args.devices or args.mesh) \
        else one_device_mesh(resolve_device(args.device))
    dev = mesh.device()
    print(f"[train] arch={cfg.name} devices={mesh.size} "
          f"mesh={dict(mesh.shape)} on {dev}")

    model = build_model(cfg, device=dev)
    opt = adamw(warmup_cosine(args.lr, warmup_steps=max(args.steps // 10, 1),
                              total_steps=args.steps))
    pipe = TokenPipeline(cfg, batch=args.batch, seq_len=args.seq_len)
    trainer = Trainer(model, opt, mesh, pipe, ckpt_dir=args.ckpt_dir,
                      microbatches=args.microbatches,
                      grad_compression=args.grad_compression,
                      ckpt_every=args.ckpt_every)
    out = trainer.run(0, args.steps)
    hist = out["history"]
    if hist:
        print(f"[train] done: step {hist[-1]['step']} "
              f"loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f} "
              f"stragglers={out['stragglers']}")


if __name__ == "__main__":
    main()
