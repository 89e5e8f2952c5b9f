"""minicpm3-4b [dense] -- 62L d_model=2560 40H d_ff=6400 vocab=73448,
Multi-head Latent Attention (MLA): q_lora 768, kv_lora 256, qk_nope 64,
qk_rope 32, v_head 64. [hf:openbmb/MiniCPM3-4B; hf]
"""
from repro_torch.configs.base import MLAConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b",
        family="dense",
        num_layers=62,
        d_model=2560,
        num_heads=40,
        num_kv_heads=40,
        head_dim=64,  # v head dim; qk dims live in MLAConfig
        d_ff=6400,
        vocab_size=73448,
        attn_kind="full",
        mlp_kind="silu_glu",
        norm_kind="rmsnorm",
        tie_embeddings=True,
        mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                      qk_nope_head_dim=64, qk_rope_head_dim=32,
                      v_head_dim=64),
        supports_long_context=False,  # full attention (MLA compresses the
        # cache but per-step cost is still O(T) over 500k; skipped per spec)
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b-smoke",
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
        norm_kind="rmsnorm",
        tie_embeddings=True,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                      qk_nope_head_dim=16, qk_rope_head_dim=8,
                      v_head_dim=16),
    )
