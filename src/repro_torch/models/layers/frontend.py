"""Modality frontend stubs (embeddings arrive precomputed).

The PyTorch counterpart of the reference's ``models/layers/frontend.py``:
``llava-next-mistral-7b``'s vision patches arrive as precomputed
features of shape (B, frontend_tokens, FRONTEND_DIM), and a learned
linear adapter (the real systems' ``mm_projector``) maps them into
d_model.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.dist import shard
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers.common import compute_dtype, const, dense_init

FRONTEND_DIM = 1024  # CLIP-large / w2v-BERT feature width


class Frontend(nn.Module):
    """``proj`` (FRONTEND_DIM, D) and a float32 ``bias`` (D,)."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.proj = dense_init((FRONTEND_DIM, cfg.d_model), FRONTEND_DIM,
                               compute_dtype(cfg), generator=generator,
                               device=device)
        self.bias = const(0.0, (cfg.d_model,), device)

    def forward(self, embeds):
        return apply_frontend(self, embeds, self.cfg)


def apply_frontend(params: Frontend, embeds: torch.Tensor,
                   cfg: ModelConfig):
    """(B, F, FRONTEND_DIM) precomputed features -> (B, F, d_model), cast
    to the model's compute dtype whatever the features' dtype."""
    dt = compute_dtype(cfg)
    y = embeds.to(dt) @ params.proj
    y = (y.float() + params.bias).to(dt)
    return shard(y, "batch", "seq", "embed")
