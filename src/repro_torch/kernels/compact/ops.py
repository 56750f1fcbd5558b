"""Stream compaction: the compact-mask registration of the scan engine.

The PyTorch counterpart of the reference's ``kernels/compact/ops.py``.
Stream compaction (filter) is the paper's §1 database use case: the new
index of every surviving element is the exclusive prefix sum of the
keep-mask at its position. The mask monoid
(``core/scan/assoc.mask_kernel_spec``) is integer SUM with the predicate
select FUSED into the writeback — surviving lanes emit their global
destination, dropped lanes emit the sentinel — so the output feeds a
scatter directly, under any of the engine's schedules: through the CUDA
kernels for a CUDA tensor, through their plain versions for a CPU one.

The wrapper handles arbitrary ranks (last-axis semantics like the cumsum
wrappers) and pads to block multiples — padded positions carry mask 0,
so they can never emit a phantom destination.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.scan import policy
from repro_torch.kernels import scan_engine
from repro_torch.kernels.scan_engine import monoids, resolve_schedule


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _impl(mask, block_b, block_n, schedule):
    lead = mask.shape[:-1]
    n = mask.shape[-1]
    b = mask.numel() // n
    # Normalize BEFORE the int cast: a fractional float mask value (0.5)
    # is "keep" per the nonzero contract; a cast alone would drop it.
    m2 = (mask.reshape(b, n) != 0).to(torch.int32)

    bb = min(block_b, b) if b % min(block_b, b) == 0 else 1
    bn = min(block_n, _round_up(n, 128))
    pad_n = (-n) % bn
    m2 = F.pad(m2, (0, pad_n)).contiguous()  # padded mask is 0: no phantoms

    layout = scan_engine.Rows(m2.shape[0], m2.shape[1], bb, bn)
    (dest,), (totals,) = scan_engine.scan(
        (m2,), monoids.mask(m2.shape[1]), layout, schedule=schedule,
        return_totals=True)
    # Survivor counts from the O(rows · chunks) running chunk-totals chain
    # the kernel already maintains — its last column is the row total
    # (exact integers, identical bits under every schedule; padded
    # positions are 0 so they never count). No second read of the mask.
    counts = totals[:, -1].to(torch.int32)
    # The kernel's sentinel is the PADDED length; remap to the caller's n
    # so a size-(n+1) scatter buffer parks every dropped element at n.
    dest = torch.clamp(dest[:, :n], max=n)
    return dest.reshape(lead + (n,)), counts.reshape(lead)


def mask_compact(
    mask: torch.Tensor,
    *,
    block_b: int = 8,
    block_n: int = 2048,
    schedule: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel-backed compaction indices along the last axis (any rank),
    on ``mask``'s device.

    Returns ``(dest, counts)`` with ``dest[..., i]`` the compacted write
    index where ``mask`` is nonzero and ``n`` (the axis length) where it
    is zero; ``counts[...]`` is the survivor count per row.
    """
    if mask.numel() == 0:  # zero-length axis OR zero-sized batch
        return (torch.zeros(mask.shape, dtype=torch.int32,
                            device=mask.device),
                torch.zeros(mask.shape[:-1], dtype=torch.int32,
                            device=mask.device))
    n = mask.shape[-1]
    batch = max(mask.numel() // max(n, 1), 1)
    bn = min(block_n, _round_up(n, 128))  # the block _impl uses
    schedule = resolve_schedule(schedule, batch, n, bn,
                                policy.cores_of(mask))
    return _impl(mask, block_b, block_n, schedule)


def mask_compact_kernel(mask, *, block_b=8, block_n=2048,
                        schedule="decoupled"):
    """Back-compat entry point: pre-padded 2D (B, N) masks only."""
    if mask.ndim != 2:
        raise ValueError(f"kernel expects 2D input, got {tuple(mask.shape)}")
    mask = (mask != 0).to(torch.int32).contiguous()
    layout = scan_engine.Rows(mask.shape[0], mask.shape[1], block_b, block_n)
    dest, = scan_engine.scan(
        (mask,), monoids.mask(mask.shape[1]), layout, schedule=schedule)
    counts = torch.sum(mask, dim=-1, dtype=torch.int32)
    return dest, counts
