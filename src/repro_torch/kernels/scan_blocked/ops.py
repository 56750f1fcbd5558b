"""Blocked prefix sum: the sum registration of the scan engine.

The PyTorch counterpart of the reference's ``kernels/scan_blocked/ops.py``.
The public wrapper handles arbitrary ranks/axes, padding to block
multiples and the schedule policy, then runs the engine's sum scan on the
``Rows`` layout: through the CUDA kernels for a CUDA tensor, through
their plain versions for a CPU tensor.

Four schedules (see ``core/scan/policy``): ``carry``, ``decoupled``,
``fused`` (runs decoupled), ``tree``; ``auto`` lets the policy's
batch-vs-cores rule decide.

``cumsum`` is differentiable through a ``torch.autograd.Function`` whose
backward is ITSELF an engine scan: the adjoint of a prefix sum is a
suffix sum, so the gradient runs the same kernel on the flipped
cotangent, with the same ``exclusive`` flag.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.scan import policy
from repro_torch.kernels import scan_engine
from repro_torch.kernels.scan_engine import monoids
from repro_torch.kernels.scan_engine import resolve_schedule


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _cumsum_impl(x, axis, exclusive, block_b, block_n, schedule):
    x = torch.movedim(x, axis, -1)
    lead = x.shape[:-1]
    n = x.shape[-1]
    b = x.numel() // n
    x2 = x.reshape(b, n)

    bb = min(block_b, b) if b % min(block_b, b) == 0 else 1
    pad_b = (-b) % bb
    bn = min(block_n, _round_up(n, 128))
    pad_n = (-n) % bn
    if pad_b or pad_n:
        x2 = F.pad(x2, (0, pad_n, 0, pad_b))
    x2 = x2.contiguous()

    layout = scan_engine.Rows(x2.shape[0], x2.shape[1], bb, bn)
    out, = scan_engine.scan((x2,), monoids.SUM, layout, schedule=schedule,
                            exclusive=exclusive)
    out = out[:b, :n].reshape(lead + (n,))
    return torch.movedim(out, -1, axis)


class _Cumsum(torch.autograd.Function):
    """Gradient-as-a-scan: d(prefix sum)/dx is a SUFFIX sum of the
    cotangent with the same exclusivity — flip, run the identical engine
    kernel, flip back."""

    @staticmethod
    def forward(ctx, x, axis, exclusive, block_b, block_n, schedule):
        ctx.statics = (axis, exclusive, block_b, block_n, schedule)
        return _cumsum_impl(x, axis, exclusive, block_b, block_n, schedule)

    @staticmethod
    def backward(ctx, g):
        axis, exclusive, block_b, block_n, schedule = ctx.statics
        # Inclusive: dx_j = sum_{i>=j} g_i; exclusive: dx_j = sum_{i>j} g_i
        # — both the same-flavour prefix sum of the reversed cotangent.
        rev = _cumsum_impl(torch.flip(g, (axis,)), axis, exclusive, block_b,
                           block_n, schedule)
        return torch.flip(rev, (axis,)), None, None, None, None, None


def cumsum(
    x: torch.Tensor,
    axis: int = -1,
    exclusive: bool = False,
    block_b: int = 8,
    block_n: int = 2048,
    schedule: str = "auto",
) -> torch.Tensor:
    """Kernel-backed prefix sum along ``axis`` (any rank), on ``x``'s
    device.

    ``schedule`` picks the organization (carry|decoupled|fused|tree|auto).
    Differentiable: the backward runs as another engine scan.
    """
    if x.numel() == 0:
        # The scan of nothing is nothing — and the padding arithmetic
        # below would divide by a zero block.
        return x
    n = x.shape[axis]
    batch = max(x.numel() // max(n, 1), 1)
    bn = min(block_n, _round_up(n, 128))  # the block _cumsum_impl uses
    schedule = resolve_schedule(schedule, batch, n, bn, policy.cores_of(x))
    return _Cumsum.apply(x, axis, exclusive, block_b, block_n, schedule)


# ---------------------------------------------------------------------------
# Back-compat kernel entry points (2D, pre-padded)
# ---------------------------------------------------------------------------


def _scan_2d(x, block_b, block_n, exclusive, schedule):
    if x.ndim != 2:
        raise ValueError(f"kernel expects 2D input, got {tuple(x.shape)}")
    layout = scan_engine.Rows(x.shape[0], x.shape[1], block_b, block_n)
    out, = scan_engine.scan((x.contiguous(),), monoids.SUM, layout,
                            schedule=schedule, exclusive=exclusive)
    return out


def scan_blocked_kernel(x, *, block_b=8, block_n=2048, exclusive=False):
    """Carry-schedule prefix sum of a pre-padded 2D (B, N) tensor."""
    return _scan_2d(x, block_b, block_n, exclusive, "carry")


def scan_blocked_decoupled(x, *, block_b=8, block_n=2048, exclusive=False):
    """Decoupled-schedule prefix sum of a pre-padded 2D (B, N) tensor."""
    return _scan_2d(x, block_b, block_n, exclusive, "decoupled")
