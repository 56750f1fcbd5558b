"""Learning-rate schedules (cosine with linear warmup)."""

from __future__ import annotations

import math

import torch


def cosine_schedule(
    step,
    *,
    peak_lr: float = 3e-4,
    warmup_steps: int = 100,
    total_steps: int = 10_000,
    min_ratio: float = 0.1,
) -> torch.Tensor:
    """Linear warmup to ``peak_lr`` then cosine decay to ``min_ratio·peak``;
    a float32 tensor on ``step``'s device (the CPU for a Python number)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(warmup_steps, 1)
    prog = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
    prog = prog.clamp(0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return peak_lr * torch.where(step < warmup_steps, warm, cos)
