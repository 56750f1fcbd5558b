"""granite-moe-1b-a400m — MoE, 32 experts top-8.

[hf:ibm-granite/granite-3.0-1b-a400m-base; hf] 24L d_model=1024 16H
(GQA kv=8) d_ff(expert)=512 vocab=49155, MoE 32e top-8. Every FFN is MoE;
prefix-sum dispatch offsets are the paper's core use case (DESIGN.md §3).
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    moe_d_ff=512,
    vocab_size=49_155,
    num_experts=32,
    top_k=8,
    layer_pattern=("moe",),
    rope_theta=10_000.0,
    act="silu",
    max_seq_len=4_096,
)

SMOKE = dataclasses.replace(
    CONFIG,
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=64,
    moe_d_ff=64,
    vocab_size=512,
    num_experts=4,
    top_k=2,
    max_seq_len=256,
)
