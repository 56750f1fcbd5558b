"""Normalization layers (params and compute kept in float32).

The PyTorch counterpart of the reference's ``models/layers/norms.py``.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers.common import const


class Norm(nn.Module):
    """``w`` (gemma_rmsnorm: zeros, its (1 + w) convention; else ones) and,
    for layernorm, a bias ``b``."""

    def __init__(self, cfg: ModelConfig, dim: "int | None" = None, *,
                 device="cuda"):
        super().__init__()
        self.cfg = cfg
        d = dim or cfg.d_model
        self.w = const(0.0 if cfg.norm == "gemma_rmsnorm" else 1.0, (d,),
                       device)
        if cfg.norm == "layernorm":
            self.b = const(0.0, (d,), device)

    def forward(self, x):
        return apply_norm(self, x, self.cfg)


def apply_norm(params: Norm, x: torch.Tensor, cfg: ModelConfig):
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        out = (xf - mu) / torch.sqrt(var + cfg.norm_eps)
        out = out * params.w + params.b
    else:
        ms = xf.square().mean(-1, keepdim=True)
        out = xf / torch.sqrt(ms + cfg.norm_eps)
        if cfg.norm == "gemma_rmsnorm":
            out = out * (1.0 + params.w)  # gemma's (1+w) convention
        else:
            out = out * params.w
    return out.to(x.dtype)


def rms_norm_headwise(w, x, eps=1e-6):
    """Per-head RMS norm for qk-norm (qwen3 / gemma3); w: (head_dim,)."""
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return ((xf / torch.sqrt(ms + eps)) * w).to(x.dtype)
