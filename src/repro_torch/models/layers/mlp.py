"""Feed-forward blocks: gated (SwiGLU/GeGLU) or plain two-layer.

The PyTorch counterpart of the reference's ``models/layers/mlp.py``.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.dist import shard
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers.common import (activation, compute_dtype,
                                              dense_init)


class MLP(nn.Module):
    """``w_up`` (D, F), ``w_down`` (F, D) and, gated, ``w_gate`` (D, F)."""

    def __init__(self, cfg: ModelConfig, d_ff: "int | None" = None, *,
                 generator=None, device="cuda"):
        super().__init__()
        self.cfg = cfg
        dt = compute_dtype(cfg)
        d, f = cfg.d_model, d_ff or cfg.d_ff
        kw = dict(generator=generator, device=device)
        self.w_up = dense_init((d, f), d, dt, **kw)
        self.w_down = dense_init((f, d), f, dt, **kw)
        if cfg.gated_mlp:
            self.w_gate = dense_init((d, f), d, dt, **kw)

    def forward(self, x):
        return apply_mlp(self, x, self.cfg)


def apply_mlp(params: MLP, x: torch.Tensor, cfg: ModelConfig):
    act = activation(cfg.act)
    up = x @ params.w_up
    if cfg.gated_mlp:
        h = act(x @ params.w_gate) * up
    else:
        h = act(up)
    h = shard(h, "batch", "seq", "mlp")
    return shard(h @ params.w_down, "batch", "seq", "embed")
