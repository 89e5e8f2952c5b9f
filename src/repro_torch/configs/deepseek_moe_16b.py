"""deepseek-moe-16b [moe] -- 28L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=102400, MoE: 2 shared + 64 routed top-6, fine-grained experts; first
layer is a dense FFN (d_ff 10944). [arXiv:2401.06066; hf]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b",
        family="moe",
        num_layers=28,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=0,
        vocab_size=102400,
        attn_kind="full",
        rope_theta=10000.0,
        mlp_kind="silu_glu",
        norm_kind="rmsnorm",
        moe=MoEConfig(
            num_experts=64, top_k=6, d_ff_expert=1408, num_shared=2,
            first_dense_layers=1, d_ff_dense_first=10944,
        ),
        supports_long_context=False,  # pure full attention
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b-smoke",
        family="moe",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=0,
        vocab_size=256,
        attn_kind="full",
        mlp_kind="silu_glu",
        norm_kind="rmsnorm",
        moe=MoEConfig(num_experts=8, top_k=3, d_ff_expert=32, num_shared=2,
                      first_dense_layers=1, d_ff_dense_first=128),
    )
