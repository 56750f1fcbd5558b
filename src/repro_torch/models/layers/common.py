"""Shared helpers for the layers: init, dtypes, activations.

The PyTorch counterpart of the reference's ``models/layers/common.py``.
Layers are ``nn.Module``s whose parameters carry the reference's names
(``wq``, ``w_up``, ``table``, ...), so a reference parameter tree maps
onto a module tree key by key (``models/convert.py``). Random init draws
from an explicit ``torch.Generator`` on the parameters' device.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _trunc_normal(shape, generator, device) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], float32 (inverse-CDF draw)."""
    edge = math.erf(2 / math.sqrt(2))   # 2 * Phi(2) - 1
    u = torch.empty(shape, dtype=torch.float32, device=device)
    u.uniform_(-edge, edge, generator=generator)
    return u.erfinv_().mul_(math.sqrt(2)).clamp_(-2.0, 2.0)


def dense_init(shape, fan_in=None, dtype=torch.bfloat16, *, generator=None,
               device="cuda") -> nn.Parameter:
    """Truncated-normal with 1/sqrt(fan_in) scaling (lecun-ish)."""
    fan_in = fan_in if fan_in is not None else shape[0]
    w = _trunc_normal(shape, generator, device).mul_(fan_in ** -0.5)
    return nn.Parameter(w.to(dtype))


def embed_init(shape, dtype=torch.bfloat16, *, generator=None,
               device="cuda") -> nn.Parameter:
    w = _trunc_normal(shape, generator, device).mul_(0.02)
    return nn.Parameter(w.to(dtype))


def const(value: float, shape, device) -> nn.Parameter:
    """A float32 parameter filled with ``value``."""
    return nn.Parameter(torch.full(shape, float(value), dtype=torch.float32,
                                   device=device))


def activation(name: str):
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
    }[name]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as the reference computes it (``logaddexp(x, 0)``)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


class Weight(nn.Module):
    """A bare weight ``w``: the reference's ``{"w": ...}`` leaves
    (``lm_head``, zamba2's per-layer ``shared_proj_in`` / ``_out``)."""

    def __init__(self, w: nn.Parameter):
        super().__init__()
        self.w = w
