"""Plain-PyTorch oracle for the blocked-scan kernel."""

from __future__ import annotations

import torch

from repro_torch.core.scan import assoc


def cumsum_ref(x: torch.Tensor, axis: int = -1,
               exclusive: bool = False) -> torch.Tensor:
    """Prefix sum with widened accumulation (``assoc.accum_dtype``)."""
    acc = assoc.accum_dtype(x.dtype)
    y = torch.cumsum(x.to(acc), dim=axis)
    if exclusive:
        y = y - x.to(acc)
    return y.to(x.dtype)
