"""Plain-PyTorch oracle for the SSM affine scan: a sequential loop."""

from __future__ import annotations

import torch

from repro_torch.core.scan import assoc


def ssm_scan_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t along axis 1 of (B, T, D); h_{-1} = 0,
    accumulated in ``assoc.accum_dtype``."""
    acc = assoc.accum_dtype(a.dtype)
    a32, b32 = a.to(acc), b.to(acc)
    h = torch.zeros_like(b32[:, 0])
    hs = []
    for t in range(a.shape[1]):
        h = a32[:, t] * h + b32[:, t]
        hs.append(h)
    if not hs:
        return b
    return torch.stack(hs, dim=1).to(b.dtype)
