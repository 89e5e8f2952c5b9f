"""Train a ~100M MoE LM on the PyTorch / CUDA port with the paper's
Sinkhorn-Knopp technique as the router, for a few hundred steps.

    PYTHONPATH=src python examples/torch_train_moe_sinkhorn.py \\
        [--steps 300] [--router sinkhorn|topk] [--devices 4] [--device cpu]

The port of `examples/train_moe_sinkhorn.py`, with its flags, defaults and
printed lines, plus ``--device``: ``cuda`` (the default) trains on the card
and raises where there is none; ``cpu`` trains on the CPU. The router
solves a token->expert optimal-transport problem per layer with the same
`repro_torch.core.ot` Sinkhorn core the WMD engine uses -- balanced expert
load by construction; ``--router topk`` is the published top-k router.
The trainer runs on a ``(n, 1)`` ("data", "model") mesh of ``--devices n``
logical devices, placed round-robin on the visible cards (0: one a
visible card; the CPU: one), checkpoints every 100 steps and at the end
under ``--ckpt-dir`` suffixed with the router, and resumes from there.
The language model runs no hand-written kernel.
"""
import argparse

from repro_torch.configs.base import ModelConfig, MoEConfig


def model_config(router: str) -> ModelConfig:
    """~100M-param MoE: 8 experts top-2, d=512, 8 layers, 16k vocab."""
    return ModelConfig(
        name=f"moe-100m-{router}", family="moe", num_layers=8,
        d_model=512, num_heads=8, num_kv_heads=4, head_dim=64, d_ff=0,
        vocab_size=16_384, attn_kind="full", mlp_kind="silu_glu",
        norm_kind="rmsnorm",
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=1024,
                      router=router),
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--router", choices=["sinkhorn", "topk"],
                    default="sinkhorn")
    ap.add_argument("--devices", type=int, default=0,
                    help="logical devices of the (n, 1) data mesh, "
                         "round-robin on the visible cards (or the CPU); "
                         "0: one a visible card")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_moe_sinkhorn")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, the default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.data import TokenPipeline
    from repro_torch.launch.mesh import logical_devices, make_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import Trainer

    devices = logical_devices(args.device, args.devices)
    cfg = model_config(args.router)
    print(f"model: {cfg.name} ~{cfg.param_count() / 1e6:.0f}M params "
          f"({cfg.active_param_count() / 1e6:.0f}M active)")

    mesh = make_mesh((len(devices), 1), ("data", "model"), devices=devices)
    model = build_model(cfg, q_block=64, kv_block=64, device=mesh.device())
    opt = adamw(warmup_cosine(3e-4, warmup_steps=args.steps // 10,
                              total_steps=args.steps))
    pipe = TokenPipeline(cfg, batch=args.batch, seq_len=args.seq_len)
    trainer = Trainer(model, opt, mesh, pipe,
                      ckpt_dir=f"{args.ckpt_dir}-{args.router}",
                      ckpt_every=100)
    out = trainer.run(0, args.steps)         # seed 0: the parameters' init
    hist = out["history"]
    print(f"[{args.router}] loss {hist[0]['loss']:.4f} -> "
          f"{hist[-1]['loss']:.4f} over {len(hist)} steps "
          f"({sum(h['sec'] for h in hist):.1f}s)")
    return out


if __name__ == "__main__":
    main()
