"""seamless-m4t-large-v2 — audio encoder-decoder (multimodal backbone).

[arXiv:2308.11596; hf] 24L d_model=1024 16H (kv=16) d_ff=8192
vocab=256206, enc-dec. The speech frontend (w2v-BERT conformer stack) is
a STUB per the assignment: ``input_specs()`` provides precomputed frame
embeddings (B, F, 1024). 24 encoder layers (non-causal) + 24 decoder
layers (causal self-attn + cross-attn + MLP). No decode skip: the decoder
serves `decode_32k` against a fixed encoder memory; `long_500k` is
skipped (enc-dec, full attention).
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256_206,
    layer_pattern=("global",),
    rope_theta=10_000.0,
    norm="layernorm",
    act="relu",
    frontend_tokens=4096,  # ~3 min of 20ms frames after subsampling
    tie_embeddings=True,
    max_seq_len=8_192,
)

SMOKE = dataclasses.replace(
    CONFIG,
    num_layers=2,
    encoder_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=256,
    vocab_size=512,
    frontend_tokens=16,
    max_seq_len=256,
)
