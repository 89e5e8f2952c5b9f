"""whisper-small [audio] -- enc-dec, 12L each, d_model=768 12H d_ff=3072
vocab=51865. Conv frontend is a STUB per the assignment: input_specs()
provides precomputed mel-frame embeddings (1500 positions) consumed by the
encoder; decoder has causal self-attention + cross-attention. Learned
positional embeddings, LayerNorm, non-gated GELU.
[arXiv:2212.04356; unverified]

Note: whisper's published decoder context is 448 tokens; the assigned
prefill/decode shapes (32k) exercise the backbone mechanically at the
framework level (position table sized to the shape) -- recorded in
DESIGN.md section 5.
"""
from repro_torch.configs.base import EncoderConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small",
        family="audio",
        num_layers=12,
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        head_dim=64,
        d_ff=3072,
        vocab_size=51865,
        attn_kind="full",
        use_rope=False,
        learned_pos=True,
        mlp_kind="gelu",
        norm_kind="layernorm",
        encoder=EncoderConfig(kind="audio_frames", num_positions=1500,
                              num_layers=12, bidirectional=True),
        supports_long_context=False,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small-smoke",
        family="audio",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        attn_kind="full",
        use_rope=False,
        learned_pos=True,
        mlp_kind="gelu",
        norm_kind="layernorm",
        encoder=EncoderConfig(kind="audio_frames", num_positions=16,
                              num_layers=2, bidirectional=True),
    )
