"""Segmented prefix sum: the SEGMENTED_SUM registration of the engine.

The PyTorch counterpart of the reference's ``kernels/segscan/ops.py``.
The segmented ``(value, flag)`` monoid (a flag kills the incoming carry —
Blelloch's lift, see ``core/scan/assoc.SEGMENTED_SUM_KERNEL``) runs
through the scan engine on the Rows layout: through the CUDA kernels for
a CUDA tensor, through their plain versions for a CPU one. The wrapper
pads with identity elements — (value 0, flag 0) extends the final
segment, which the slice-back removes — and handles arbitrary rank.
``schedule`` picks the organization (see ``core/scan/policy``): carry,
decoupled, fused (runs decoupled), tree, or the policy's auto rule.

Differentiable w.r.t. ``values`` through a ``torch.autograd.Function``
whose backward is another engine segmented scan: the adjoint sums each
cotangent backward to its segment start, a REVERSED segmented scan whose
boundaries are the forward flags shifted one step left (the boundary
AFTER an element is what stops gradient flowing back into it). Flags are
structure, not signal: their gradient is None.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.scan import policy
from repro_torch.kernels import scan_engine
from repro_torch.kernels.scan_engine import monoids, resolve_schedule


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _impl(values, flags, block_b, block_n, schedule):
    lead = values.shape[:-1]
    n = values.shape[-1]
    b = values.numel() // n
    v2 = values.reshape(b, n)
    # Normalize BEFORE the int cast: a fractional float flag (0.5) must
    # still mark a boundary; a cast alone would truncate it to 0.
    f2 = (flags.reshape(b, n) != 0).to(torch.int32)

    bb = min(block_b, b) if b % min(block_b, b) == 0 else 1
    bn = min(block_n, _round_up(n, 128))
    pad_b = (-b) % bb
    pad_n = (-n) % bn
    v2 = F.pad(v2, (0, pad_n, 0, pad_b)).contiguous()
    f2 = F.pad(f2, (0, pad_n, 0, pad_b)).contiguous()
    layout = scan_engine.Rows(v2.shape[0], v2.shape[1], bb, bn)
    out, = scan_engine.scan((v2, f2), monoids.SEGMENTED_SUM, layout,
                            schedule=schedule)
    return out[:b, :n].reshape(lead + (n,))


class _SegmentedCumsum(torch.autograd.Function):
    """dv_i = Σ_{j >= i, no boundary in (i, j]} g_j: a reversed segmented
    scan of the cotangent whose restart flags are the forward flags
    shifted one LEFT (flag'_j = flag_{j+1}; zero-fill at the end) —
    killing the reversed carry at j exactly when a segment boundary sits
    at j+1. Runs through the same engine ``_impl``."""

    @staticmethod
    def forward(ctx, values, flags, block_b, block_n, schedule):
        ctx.save_for_backward(flags)
        ctx.statics = (block_b, block_n, schedule)
        return _impl(values, flags, block_b, block_n, schedule)

    @staticmethod
    def backward(ctx, g):
        (flags,) = ctx.saved_tensors
        block_b, block_n, schedule = ctx.statics
        shifted = torch.cat(
            [flags[..., 1:], torch.zeros_like(flags[..., :1])], dim=-1)
        rev = _impl(torch.flip(g, (-1,)), torch.flip(shifted, (-1,)),
                    block_b, block_n, schedule)
        return torch.flip(rev, (-1,)), None, None, None, None


def segmented_cumsum(
    values: torch.Tensor,
    flags: torch.Tensor,
    block_b: int = 8,
    block_n: int = 2048,
    schedule: str = "auto",
) -> torch.Tensor:
    """Kernel-backed segmented cumsum along the last axis (any rank), on
    ``values``' device.

    Differentiable w.r.t. ``values``; the backward is itself an engine
    segmented scan (see module doc).
    """
    if values.shape != flags.shape:
        raise ValueError(f"expect matching shapes, got {tuple(values.shape)} "
                         f"{tuple(flags.shape)}")
    if values.numel() == 0:
        # Empty scan axis or batch: identity — the padding arithmetic
        # below would otherwise divide by a zero block.
        return values
    n = values.shape[-1]
    batch = max(values.numel() // max(n, 1), 1)
    bn = min(block_n, _round_up(n, 128))  # the block _impl uses
    schedule = resolve_schedule(schedule, batch, n, bn,
                                policy.cores_of(values))
    return _SegmentedCumsum.apply(values, flags, block_b, block_n, schedule)


# ---------------------------------------------------------------------------
# Back-compat kernel entry points (2D, pre-padded)
# ---------------------------------------------------------------------------


def _segscan_2d(values, flags, block_b, block_n, schedule):
    if values.shape != flags.shape or values.ndim != 2:
        raise ValueError(f"expect matching 2D inputs, got "
                         f"{tuple(values.shape)} {tuple(flags.shape)}")
    layout = scan_engine.Rows(values.shape[0], values.shape[1], block_b,
                              block_n)
    out, = scan_engine.scan(
        (values.contiguous(), (flags != 0).to(torch.int32).contiguous()),
        monoids.SEGMENTED_SUM, layout, schedule=schedule)
    return out


def segscan_kernel(values, flags, *, block_b=8, block_n=2048):
    """Carry-schedule segmented cumsum of pre-padded 2D (B, N) inputs."""
    return _segscan_2d(values, flags, block_b, block_n, "carry")


def segscan_decoupled(values, flags, *, block_b=8, block_n=2048):
    """Decoupled-schedule segmented cumsum of pre-padded 2D inputs."""
    return _segscan_2d(values, flags, block_b, block_n, "decoupled")
