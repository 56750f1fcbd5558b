"""Oracle for the segmented-scan kernel: a sequential scan of the
segmented-sum monoid (restart at every nonzero flag)."""

from __future__ import annotations

import torch


def segmented_cumsum_ref(values: torch.Tensor,
                         flags: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented cumsum along the LAST axis, accumulated in
    float32 and cast back to ``values``' dtype.

    values: (..., N) numeric; flags: (..., N), nonzero starts a segment.
    A Python loop over N, for checks at small sizes.
    """
    v = values.to(torch.float32)
    f = flags != 0
    carry = torch.zeros_like(v[..., 0])
    outs = []
    for i in range(v.shape[-1]):
        carry = torch.where(f[..., i], v[..., i], carry + v[..., i])
        outs.append(carry)
    if not outs:
        return values
    return torch.stack(outs, dim=-1).to(values.dtype)
