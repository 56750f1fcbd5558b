"""xlstm-125m — xLSTM with alternating mLSTM/sLSTM blocks.

[arXiv:2405.04517; unverified] 12L d_model=768 4H (kv=4) d_ff=0
vocab=50304. The xLSTM[7:1]-style stack: mostly mLSTM (matrix-memory,
fully parallelizable via the matrix-affine scan) with sLSTM blocks
(scalar-memory, gated FFN pf=4/3) interleaved. d_ff=0 per the assignment:
mLSTM blocks carry their own up/down projection (expand factor 2) and
sLSTM blocks use the 4/3-gated FFN — there is no standalone transformer
MLP. Pure recurrent: runs long_500k.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50_304,
    # 12 layers = 2 periods of [5 mLSTM, 1 sLSTM] — the 7:1-ish mix at 12L.
    layer_pattern=("mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "slstm"),
    ssm_heads=4,
    ssm_head_dim=384,  # inner = expand(2) * d_model / heads
    ssm_expand=2,
    ssm_state=0,
    gated_mlp=True,
    act="gelu",
    tie_embeddings=True,
    max_seq_len=1_048_576,
)

SMOKE = dataclasses.replace(
    CONFIG,
    num_layers=6,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    ssm_heads=4,
    ssm_head_dim=32,
    vocab_size=512,
    max_seq_len=256,
)
