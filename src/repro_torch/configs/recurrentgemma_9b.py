"""recurrentgemma-9b [hybrid] -- 38L d_model=4096 16H (kv=1 MQA on the
attention layers) d_ff=12288 vocab=256000, Griffin block pattern: RG-LRU,
RG-LRU, local attention (1:2 attn:recurrent), window 2048.
[arXiv:2402.19427; unverified]
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        num_layers=38,
        d_model=4096,
        num_heads=16,
        num_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab_size=256000,
        block_pattern=("rglru", "rglru", "attn"),
        attn_kind="local",
        window=2048,
        mlp_kind="geglu",
        norm_kind="rmsnorm",
        embed_scale=True,
        tie_embeddings=True,
        rglru_conv_width=4,
        supports_long_context=True,  # RG-LRU state + bounded local window
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b-smoke",
        family="hybrid",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=1,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        block_pattern=("rglru", "rglru", "attn"),
        attn_kind="local",
        window=16,
        mlp_kind="geglu",
        norm_kind="rmsnorm",
        embed_scale=True,
        tie_embeddings=True,
        supports_long_context=True,
    )
