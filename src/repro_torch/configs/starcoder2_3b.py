"""starcoder2-3b [dense] -- 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152, GQA + RoPE, LayerNorm, non-gated GELU MLP.
[arXiv:2402.19173; hf]
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b",
        family="dense",
        num_layers=30,
        d_model=3072,
        num_heads=24,
        num_kv_heads=2,
        head_dim=128,
        d_ff=12288,
        vocab_size=49152,
        attn_kind="full",
        rope_theta=100_000.0,
        mlp_kind="gelu",
        norm_kind="layernorm",
        supports_long_context=False,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        attn_kind="full",
        mlp_kind="gelu",
        norm_kind="layernorm",
    )
