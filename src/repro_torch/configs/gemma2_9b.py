"""gemma2-9b — dense, alternating local/global attention, logit softcaps.

[arXiv:2408.00118; hf] 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000. Gemma-2 wiring: local(4096-window)/global alternation,
attention-logit softcap 50, final-logit softcap 30, sandwich norms, GeGLU.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256_000,
    layer_pattern=("local", "global"),
    sliding_window=4096,
    rope_theta=10_000.0,
    attn_softcap=50.0,
    final_softcap=30.0,
    query_scale=256.0 ** -0.5,
    norm="gemma_rmsnorm",
    act="gelu",
    post_block_norm=True,
    max_seq_len=8_192,
)

SMOKE = dataclasses.replace(
    CONFIG,
    num_layers=4,
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
