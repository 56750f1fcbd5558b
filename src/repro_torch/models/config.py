"""Model configuration schema shared by all 10 assigned architectures
(the PyTorch port's copy of the reference's ``models/config.py``)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (exact values live in
    repro_torch/configs/)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio

    num_layers: int = 12
    d_model: int = 768
    num_heads: int = 12
    num_kv_heads: int = 12
    head_dim: int = 64
    d_ff: int = 3072
    vocab_size: int = 32000

    # --- attention ---
    rope_theta: float = 10_000.0
    rope_theta_local: Optional[float] = None  # gemma3 local layers
    sliding_window: Optional[int] = None      # width for "local" layers
    attn_softcap: Optional[float] = None      # gemma2 logit soft-capping
    final_softcap: Optional[float] = None     # gemma2 LM-head soft-capping
    qk_norm: bool = False                     # qwen3 / gemma3 per-head norm
    query_scale: Optional[float] = None       # overrides 1/sqrt(head_dim)

    # --- layer wiring ---
    # One period of block kinds; tiled num_layers//len(pattern) times, with
    # any remainder taken as a prefix of the pattern. Kinds:
    #   global | local | moe | mamba | slstm | mlstm | shared_attn
    layer_pattern: Tuple[str, ...] = ("global",)

    # --- norm / mlp ---
    norm: str = "rmsnorm"  # rmsnorm | layernorm | gemma_rmsnorm
    norm_eps: float = 1e-6
    act: str = "silu"      # silu | gelu | relu
    gated_mlp: bool = True
    post_block_norm: bool = False  # gemma2/3 extra post-norms

    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    router_z_coef: float = 1e-3

    # --- SSM (mamba2 / xlstm) ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    ssm_expand: int = 2
    conv_kernel: int = 4
    ssm_chunk: int = 128

    # --- enc-dec (seamless) ---
    encoder_layers: int = 0  # > 0 ⇒ encoder-decoder with cross attention

    # --- modality frontend stub (vlm / audio): inputs arrive as embeddings
    frontend_tokens: int = 0  # prepended precomputed-embedding positions

    # --- misc ---
    tie_embeddings: bool = True
    max_seq_len: int = 131_072
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError("num_heads must divide evenly by num_kv_heads")
        if self.family == "moe" and not (self.num_experts and self.top_k):
            raise ValueError("moe family requires num_experts and top_k")

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def pattern_periods(self) -> tuple[int, int]:
        """(full periods, remainder layers) of layer_pattern in num_layers."""
        p = len(self.layer_pattern)
        return self.num_layers // p, self.num_layers % p

    @property
    def ssm_inner(self) -> int:
        return self.ssm_heads * self.ssm_head_dim

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks); used for
        MODEL_FLOPS = 6·N·D in the roofline analysis."""
        d = self.d_model
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_kind = {}
        attn = d * self.num_heads * self.head_dim + 2 * d * self.num_kv_heads \
            * self.head_dim + self.num_heads * self.head_dim * d
        mlp = (3 if self.gated_mlp else 2) * d * self.d_ff
        per_kind["global"] = attn + mlp
        per_kind["local"] = attn + mlp
        # per-layer in/out projections around the ONE shared block
        per_kind["shared_attn"] = 3 * d * d + 2 * d
        router = d * self.num_experts
        expert = (3 if self.gated_mlp else 2) * d * self.moe_d_ff
        per_kind["moe"] = attn + router + self.num_experts * expert
        inner = self.ssm_heads * self.ssm_head_dim or self.ssm_expand * d
        conv_dim = inner + 2 * self.ssm_state
        per_kind["mamba"] = (d * (2 * inner + 2 * self.ssm_state
                                  + self.ssm_heads) + inner * d
                             + (self.conv_kernel + 1) * conv_dim
                             + 3 * self.ssm_heads + inner)
        # exact per init_slstm/init_mlstm (models/layers/xlstm.py)
        sl_heads = self.ssm_heads or self.num_heads
        sl_dh = d // sl_heads
        per_kind["slstm"] = (4 * (d * d + sl_heads * sl_dh * sl_dh
                                  + sl_heads * sl_dh)
                             + d + d * d
                             + (3 if self.gated_mlp else 2) * d
                             * (4 * d // 3) + 2 * d)
        m_inner = self.ssm_expand * d
        per_kind["mlstm"] = (d * 2 * m_inner
                             + (self.conv_kernel + 1) * m_inner
                             + 3 * m_inner * m_inner
                             + 2 * (m_inner * sl_heads + sl_heads)
                             + m_inner + m_inner * d)
        periods, rem = self.pattern_periods
        kinds = list(self.layer_pattern) * periods + \
            list(self.layer_pattern[:rem])
        total = emb + sum(per_kind.get(k, attn + mlp) for k in kinds)
        if "shared_attn" in self.layer_pattern:
            total += per_kind["global"]  # the ONE shared attn+mlp block
        if self.is_encdec:
            total += self.encoder_layers * (attn + mlp) \
                + self.num_layers * attn  # cross-attention
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        expert = (3 if self.gated_mlp else 2) * d * self.moe_d_ff
        total = self.param_count()
        total -= self.num_layers * (self.num_experts - self.top_k) * expert
        return int(total)
