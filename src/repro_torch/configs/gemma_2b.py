"""gemma-2b [dense] -- 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000,
GeGLU MLP, head_dim=256, embeddings scaled by sqrt(d_model), tied softmax.
[arXiv:2403.08295; hf]
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b",
        family="dense",
        num_layers=18,
        d_model=2048,
        num_heads=8,
        num_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab_size=256000,
        attn_kind="full",
        mlp_kind="geglu",
        norm_kind="rmsnorm",
        embed_scale=True,
        tie_embeddings=True,
        supports_long_context=False,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=1,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        attn_kind="full",
        mlp_kind="geglu",
        norm_kind="rmsnorm",
        embed_scale=True,
        tie_embeddings=True,
    )
