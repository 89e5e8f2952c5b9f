"""paligemma-3b [vlm] -- 18L d_model=2048 8H (kv=1) d_ff=16384 vocab=257216,
SigLIP vision tower + gemma-2B text backbone. The SigLIP frontend is a STUB
per the assignment: input_specs() provides precomputed patch embeddings
(256 patches at 224px/14px) which the backbone consumes as a full-attention
prefix (prefix-LM masking). [arXiv:2407.07726; hf]
"""
from repro_torch.configs.base import EncoderConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b",
        family="vlm",
        num_layers=18,
        d_model=2048,
        num_heads=8,
        num_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab_size=257216,
        attn_kind="full",
        mlp_kind="geglu",
        norm_kind="rmsnorm",
        embed_scale=True,
        tie_embeddings=True,
        encoder=EncoderConfig(kind="image_patches", num_positions=256,
                              num_layers=0, bidirectional=True),
        supports_long_context=False,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b-smoke",
        family="vlm",
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
        encoder=EncoderConfig(kind="image_patches", num_positions=8,
                              num_layers=0, bidirectional=True),
    )
