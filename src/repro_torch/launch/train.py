"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Port of `repro.launch.train`: the fault-tolerant trainer on one device
(``--device``, the card by default; ``--device cpu`` for the CPU). It
takes the reference's flags; ``--devices`` / ``--mesh`` beyond one
position raise `NotImplementedError` (the multi-device LM mesh is ROADMAP
Queue 1 item 5d). ``--smoke`` uses the reduced config. A rerun with the
same ``--ckpt-dir`` resumes from its latest checkpoint (``[trainer]
restoring step N``). The checkpoint directory defaults to
``repro_torch_ckpt`` under the temporary directory.

    python -m repro_torch.launch.train --arch gemma-2b --smoke --steps 4 \\
        --ckpt-every 2 --batch 2 --seq-len 32 --device cpu
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
                    help="devices of the mesh (one: more raise)")
    ap.add_argument("--mesh", default="",
                    help="e.g. 1x1 -> (data=1, model=1); more positions "
                         "raise")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (the card by default)")
    args = ap.parse_args(argv)

    import dataclasses

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import _device
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import Trainer

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.router and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, router=args.router))

    n_dev = args.devices or 1
    if args.mesh:
        shape = tuple(int(x) for x in args.mesh.split("x"))
        axes = ("data", "model") if len(shape) == 2 \
            else ("pod", "data", "model")
    else:
        shape, axes = (n_dev, 1), ("data", "model")
    if n_dev != 1 or any(s != 1 for s in shape):
        raise NotImplementedError(
            f"--devices {args.devices} --mesh {args.mesh or 'default'}: the "
            f"port trains a language model on one device; the multi-device "
            f"LM mesh is ROADMAP Queue 1 item 5d")
    dev = _device(args.device)
    mesh = make_mesh(shape, axes, devices=[dev])
    print(f"[train] arch={cfg.name} devices={n_dev} "
          f"mesh={dict(zip(axes, shape))} on {dev}")

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
