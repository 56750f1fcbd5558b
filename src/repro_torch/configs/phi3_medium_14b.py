"""phi3-medium-14b — dense decoder, RoPE + SwiGLU + GQA.

[arXiv:2404.14219; unverified] 40L d_model=5120 40H (GQA kv=10)
d_ff=17920 vocab=100352. Standard pre-norm Llama-style wiring.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    head_dim=128,
    d_ff=17920,
    vocab_size=100_352,
    layer_pattern=("global",),
    rope_theta=10_000.0,
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
    d_ff=256,
    vocab_size=512,
    max_seq_len=256,
)
