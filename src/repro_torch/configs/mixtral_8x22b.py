"""mixtral-8x22b [moe] -- 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b",
        family="moe",
        num_layers=56,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=0,  # every layer is MoE
        vocab_size=32768,
        attn_kind="swa",
        window=4096,
        rope_theta=1_000_000.0,
        mlp_kind="silu_glu",
        norm_kind="rmsnorm",
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=16384),
        supports_long_context=True,  # SWA bounds the KV cache at `window`
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=0,
        vocab_size=256,
        attn_kind="swa",
        window=16,
        mlp_kind="silu_glu",
        norm_kind="rmsnorm",
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128),
        supports_long_context=True,
    )
