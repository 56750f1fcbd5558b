"""stablelm-12b — dense decoder with GQA.

[hf:stabilityai/stablelm-2-1_6b family; hf] 40L d_model=5120 32H
(GQA kv=8) d_ff=13824 vocab=100352. StableLM-2 wiring: LayerNorm
(parametric), SwiGLU, partial-rotary RoPE (we apply full rotary — noted in
DESIGN.md deviations), untied embeddings.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=160,
    d_ff=13824,
    vocab_size=100_352,
    layer_pattern=("global",),
    rope_theta=10_000.0,
    norm="layernorm",
    act="silu",
    tie_embeddings=False,
    max_seq_len=4_096,
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
