"""Config system: every architecture is a frozen dataclass instance.

One file per assigned architecture under `repro_torch.configs`; each exposes
``config()`` returning the exact published dims plus ``smoke_config()``
returning a reduced same-family config for CPU smoke tests. The registry
(`repro_torch.configs.registry`) maps ``--arch <id>`` to these.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int                 # routed experts
    top_k: int
    d_ff_expert: int                 # per-expert hidden dim
    num_shared: int = 0              # always-on shared experts (deepseek)
    capacity_factor: float = 1.25
    router: str = "topk"             # "topk" | "sinkhorn" (paper's technique)
    sinkhorn_iters: int = 8
    sinkhorn_lamb: float = 8.0
    router_aux_loss: float = 0.01    # load-balance aux loss weight (topk)
    first_dense_layers: int = 0      # deepseek: layer 0 is a dense FFN
    d_ff_dense_first: int = 0        # hidden dim of that dense first layer


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (MiniCPM3 / DeepSeek-V2 style)."""
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Frontend/encoder for [audio]/[vlm] archs. The modality frontend is a
    STUB per the assignment: input_specs() provides precomputed frame/patch
    embeddings; only the transformer backbone is real."""
    kind: str                        # "audio_frames" | "image_patches"
    num_positions: int               # frames (whisper: 1500) / patches (256)
    num_layers: int = 0              # encoder transformer depth (whisper)
    bidirectional: bool = True


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int                        # dense-MLP hidden (0 = no separate MLP)
    vocab_size: int

    # block structure: repeating pattern of layer kinds; len must divide into
    # num_layers with the remainder unrolled. kinds: "attn", "mlstm", "slstm",
    # "rglru".
    block_pattern: Tuple[str, ...] = ("attn",)

    # attention details
    attn_kind: str = "full"          # full | swa | local (window-limited)
    window: int = 0                  # swa/local window size
    rope_theta: float = 10000.0
    use_rope: bool = True
    learned_pos: bool = False        # whisper-style learned positions
    logit_softcap: float = 0.0

    # mlp / norm
    mlp_kind: str = "silu_glu"       # silu_glu | geglu | gelu (non-gated)
    norm_kind: str = "rmsnorm"       # rmsnorm | layernorm | nonparam_ln
    embed_scale: bool = False        # gemma: embeddings * sqrt(d_model)
    tie_embeddings: bool = False

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    # absorbed MLA decode (W_uk folded into q, W_uv into output): same math,
    # O(S*(r+rope)) per head instead of re-expanding K/V -- §Perf hillclimb
    # for decode_32k x minicpm3. False = paper-naive decode for A/B.
    mla_absorbed: bool = True
    encoder: Optional[EncoderConfig] = None
    rglru_conv_width: int = 4        # recurrentgemma conv1d temporal width

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # long_500k applicability: True only for sub-quadratic sequence mixing
    # (state recurrences or bounded attention windows). DESIGN.md section 5.
    supports_long_context: bool = False

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for sanity."""
        d, l = self.d_model, self.num_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        n_attn = sum(1 for k in self._layer_kinds() if k == "attn")
        n_rec = l - n_attn
        # attention
        if self.mla is not None:
            m = self.mla
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            per_attn = (d * m.q_lora_rank + m.q_lora_rank * self.num_heads * qk
                        + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                        + m.kv_lora_rank * self.num_heads
                        * (m.qk_nope_head_dim + m.v_head_dim)
                        + self.num_heads * m.v_head_dim * d)
        else:
            per_attn = (d * self.num_heads * self.head_dim * 2
                        + d * self.num_kv_heads * self.head_dim * 2)
        # recurrent blocks, per kind: rglru has 5 full d x d matrices
        # (gate, in, a, x, out); mlstm 6 (up, gate, q, k, v, down);
        # slstm ~6 effective (w = 4 d^2 block + gate/down + block-diag R)
        rec_weights = {"rglru": 5, "mlstm": 6, "slstm": 6}
        per_rec_by_kind = {k: n * d * d for k, n in rec_weights.items()}
        kinds = self._layer_kinds()
        rec_total = sum(per_rec_by_kind.get(k, 0) for k in kinds
                        if k != "attn")
        per_rec = 0  # folded into rec_total below
        # mlp
        if self.moe is not None:
            e = self.moe
            per_mlp = (e.num_experts + e.num_shared) * 3 * d * e.d_ff_expert \
                + d * e.num_experts
        elif self.d_ff > 0:
            gates = 3 if self.mlp_kind in ("silu_glu", "geglu") else 2
            per_mlp = gates * d * self.d_ff
        else:
            per_mlp = 0
        per_layer = per_mlp
        total = emb + n_attn * per_attn + rec_total + l * per_layer
        if self.encoder is not None and self.encoder.num_layers:
            enc_attn = 4 * d * d
            enc_mlp = 2 * d * self.d_ff
            total += self.encoder.num_layers * (enc_attn + enc_mlp)
            total += n_attn * 2 * d * d  # decoder cross-attention (approx)
        return total

    def active_param_count(self) -> int:
        """Params touched per token: MoE counts shared + top_k experts only
        (the 6*N_active*D convention for MoE MFU)."""
        if self.moe is None:
            return self.param_count()
        e = self.moe
        per_expert = 3 * self.d_model * e.d_ff_expert
        inactive = (e.num_experts - e.top_k) * per_expert \
            * (self.num_layers - e.first_dense_layers)
        return self.param_count() - inactive

    def _layer_kinds(self) -> Tuple[str, ...]:
        reps = self.num_layers // len(self.block_pattern)
        tail = self.num_layers % len(self.block_pattern)
        return self.block_pattern * reps + self.block_pattern[:tail]

    def layer_kinds(self) -> Tuple[str, ...]:
        return self._layer_kinds()


# the four assigned input shapes (LM family)
@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
