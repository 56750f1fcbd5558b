"""Rotary position embeddings (NeoX half-rotation convention).

The PyTorch counterpart of the reference's ``models/layers/rope.py``.
"""

from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, theta: float, device=None
                     ) -> torch.Tensor:
    half = head_dim // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotate (..., S, head_dim) by per-position angles.

    positions: (S,) or broadcastable to x's sequence axis (-2).
    """
    half = x.shape[-1] // 2
    freqs = rope_frequencies(x.shape[-1], theta, x.device)  # (half,)
    angles = positions[..., :, None].float() * freqs        # (S, half)
    cos = torch.cos(angles)
    sin = torch.sin(angles)
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
