"""Token embedding and LM head (optionally tied).

The PyTorch counterpart of the reference's ``models/layers/embedding.py``.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.dist import shard
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers.common import (Weight, compute_dtype,
                                              embed_init)


class Embedding(nn.Module):
    """The token table ``table`` (V, D)."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device="cuda"):
        super().__init__()
        self.table = embed_init((cfg.vocab_size, cfg.d_model),
                                compute_dtype(cfg), generator=generator,
                                device=device)


def init_lm_head(cfg: ModelConfig, *, generator=None, device="cuda"):
    """The untied head ``{"w": (D, V)}``."""
    return Weight(embed_init((cfg.d_model, cfg.vocab_size),
                             compute_dtype(cfg), generator=generator,
                             device=device))


def embed_tokens(params, tokens, cfg: ModelConfig):
    """tokens (B, S) int -> (B, S, D). Gemma-style sqrt(d) scaling when
    embeddings are tied (keeps tied-logit scale sane). ``params`` holds
    ``embed`` (an ``Embedding``)."""
    table = params.embed.table
    x = table[tokens.long()]
    if cfg.tie_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return shard(x, "batch", "seq", "embed")


def lm_logits(params, h, cfg: ModelConfig):
    """(B, S, D) -> (B, S, V) float32 logits (+ gemma2 final softcap)."""
    if cfg.tie_embeddings:
        w = params.embed.table.float()                       # (V, D)
        logits = torch.einsum("bsd,vd->bsv", h.float(), w)
    else:
        w = params.lm_head.w.float()                         # (D, V)
        logits = torch.einsum("bsd,dv->bsv", h.float(), w)
    if cfg.final_softcap is not None:
        c = cfg.final_softcap
        logits = c * torch.tanh(logits / c)
    return shard(logits, "batch", "seq", "vocab")
