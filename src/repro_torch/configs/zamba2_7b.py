"""zamba2-7b — hybrid Mamba2 backbone + shared attention block.

[arXiv:2411.15242; unverified] 81L d_model=3584 32H (kv=32) d_ff=14336
vocab=32000, ssm_state=64. Zamba2 wiring: a deep Mamba2 trunk with ONE
shared attention+MLP block invoked periodically; each invocation
concatenates the current hidden state with the original embedding
(``concat(x, x0)``), runs per-layer in/out projections around the shared
weights. 81 = 27 periods of (mamba, mamba, shared_attn). Sub-quadratic:
runs long_500k (the shared-attn KV grows, but decode is O(n)/step; the
Mamba trunk is O(1)/step).
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32_000,
    layer_pattern=("mamba", "mamba", "shared_attn"),
    rope_theta=10_000.0,
    act="gelu",
    ssm_heads=112,     # inner = expand(2)·3584 = 7168; head_dim 64
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_state=64,
    conv_kernel=4,
    ssm_chunk=128,
    max_seq_len=1_048_576,
)

SMOKE = dataclasses.replace(
    CONFIG,
    num_layers=6,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=256,
    vocab_size=512,
    ssm_heads=4,
    ssm_head_dim=32,
    ssm_state=16,
    max_seq_len=256,
)
