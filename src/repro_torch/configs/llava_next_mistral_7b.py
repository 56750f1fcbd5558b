"""llava-next-mistral-7b — VLM: Mistral-7B backbone + anyres patch stub.

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified] 32L d_model=4096 32H
(GQA kv=8) d_ff=14336 vocab=32000. The assignment specifies the
transformer BACKBONE only; the vision tower is a STUB — ``input_specs()``
provides precomputed patch embeddings (anyres tiling: up to 5 tiles of
24×24 = 2880 patch positions at 1024-d, projected by a learned 2-layer
adapter into d_model and prepended to the text sequence).
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32_000,
    layer_pattern=("global",),
    rope_theta=1_000_000.0,
    act="silu",
    frontend_tokens=2880,  # anyres: 5 tiles × 576 patches
    tie_embeddings=False,
    max_seq_len=32_768,
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
    frontend_tokens=16,
    max_seq_len=256,
)
