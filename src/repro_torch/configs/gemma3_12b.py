"""gemma3-12b — dense, 5:1 local:global attention, 128k context.

[hf:google/gemma-3-1b-pt family; unverified] 48L d_model=3840 16H
(GQA kv=8) d_ff=15360 vocab=262144. Gemma-3 wiring: pattern of five
sliding-window (1024) layers followed by one global layer; separate RoPE
bases (10k local / 1M global); per-head qk-norm; sandwich (post-block)
norms; GeGLU MLP.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262_144,
    layer_pattern=("local", "local", "local", "local", "local", "global"),
    sliding_window=1024,
    rope_theta=1_000_000.0,
    rope_theta_local=10_000.0,
    qk_norm=True,
    query_scale=256.0 ** -0.5,
    norm="gemma_rmsnorm",
    act="gelu",
    post_block_norm=True,
    max_seq_len=131_072,
)

SMOKE = dataclasses.replace(
    CONFIG,
    num_layers=6,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=256,
    vocab_size=512,
    sliding_window=32,
    query_scale=16.0 ** -0.5,
    max_seq_len=256,
)
