"""qwen3-moe-235b-a22b — MoE, 128 experts top-8.

[hf:Qwen/Qwen3-30B-A3B family; hf] 94L d_model=4096 64H (GQA kv=4)
d_ff(expert)=1536 vocab=151936, MoE 128e top-8, per-head qk-norm.
Largest assigned arch; exercises expert parallelism (128/16 = 8 experts
per model-axis chip) and the scan-offset dispatch at scale.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    moe_d_ff=1536,
    vocab_size=151_936,
    num_experts=128,
    top_k=8,
    layer_pattern=("moe",),
    rope_theta=1_000_000.0,
    qk_norm=True,
    act="silu",
    tie_embeddings=False,
    max_seq_len=131_072,
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
    num_experts=8,
    top_k=2,
    max_seq_len=256,
)
