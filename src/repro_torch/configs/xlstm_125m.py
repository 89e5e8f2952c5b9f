"""xlstm-125m [ssm] -- 12L d_model=768 4H d_ff=0 vocab=50304, sLSTM + mLSTM
blocks. Pattern chosen as 5 mLSTM : 1 sLSTM per 6-layer unit (the xLSTM
paper's LM configs are mLSTM-dominant, e.g. xLSTM[7:1]); source is tagged
`unverified` in the assignment so the ratio is a documented choice.
[arXiv:2405.04517; unverified]
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m",
        family="ssm",
        num_layers=12,
        d_model=768,
        num_heads=4,
        num_kv_heads=4,
        head_dim=192,
        d_ff=0,  # xLSTM blocks carry their own up/down projections
        vocab_size=50304,
        block_pattern=("mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "slstm"),
        attn_kind="none",
        use_rope=False,
        norm_kind="layernorm",
        supports_long_context=True,  # recurrent state, O(1) per decode step
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m-smoke",
        family="ssm",
        num_layers=2,
        d_model=64,
        num_heads=2,
        num_kv_heads=2,
        head_dim=32,
        d_ff=0,
        vocab_size=256,
        block_pattern=("mlstm", "slstm"),
        attn_kind="none",
        use_rope=False,
        norm_kind="layernorm",
        supports_long_context=True,
    )
