"""olmo-1b [dense] -- 16L d_model=2048 16H d_ff=8192 vocab=50304, SwiGLU MLP,
non-parametric LayerNorm (no learnable scale/bias -- OLMo's hallmark).
[arXiv:2402.00838; hf]
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b",
        family="dense",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=8192,
        vocab_size=50304,
        attn_kind="full",
        mlp_kind="silu_glu",
        norm_kind="nonparam_ln",
        tie_embeddings=True,
        supports_long_context=False,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        attn_kind="full",
        mlp_kind="silu_glu",
        norm_kind="nonparam_ln",
        tie_embeddings=True,
    )
