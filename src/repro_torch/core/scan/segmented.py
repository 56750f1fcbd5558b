"""Segmented scans and partitioning-offset helpers.

The PyTorch counterpart of the reference's ``core/scan/segmented.py``.
This module hosts the paper's *motivating database use case* (§1):
"prefix sums are computed from a previously constructed histogram ...
and then used as the new index values" during a partitioning step —
here the offsets of a radix partition (relational) or of MoE token
dispatch: elements are partitioned by bucket, each bucket's base write
offset is the exclusive prefix sum of the histogram, and each element's
slot within its bucket is its running per-bucket rank (a one-hot scan).

Route for the integer scans (``dispatch_offsets``,
``packed_segment_ids``): on a CPU tensor the sequential ``scan_ref``, as
the reference runs them; on a CUDA tensor the port's own kernel cumsum
(``algorithm="kernel"``). The reference's ``scan_ref`` is one compiled
``lax.scan``; the port's is a Python loop, which at a column store's T
would never finish on the card. These are integer sums, so every
association gives the same bits: a difference of route, not of result.
The one-hot is built directly as (E, T) int32, so the scan runs along the
last axis with no transposed copy (never through ``one_hot``, whose int64
would take twice the memory).

Offsets are int32 and a dispatch over 2^31 items or more raises: the port
has no x64 switch and does what the reference does with x64 off.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.scan import assoc
from repro_torch.core.scan import reference


def segmented_scan(
    values,
    flags,
    op: "str | assoc.Monoid" = "sum",
    axis: int = -1,
    algorithm: str = "ref",
):
    """Inclusive scan restarting wherever ``flags != 0``.

    ``algorithm="kernel"`` routes sum-segmented scans through the scan
    engine's segmented registration (``kernels/segscan``: the CUDA
    kernels for a CUDA tensor), under whichever schedule
    ``core/scan/policy`` picks for the shape. ``"ref"`` is the sequential
    library scan (a Python loop over the axis: small sizes only).
    """
    if algorithm == "kernel":
        if assoc.get(op).name != "sum":
            raise ValueError("kernel path supports the sum monoid")
        from repro_torch.kernels.segscan import ops as seg_ops
        v = torch.movedim(values, axis, -1)
        f = torch.movedim(flags, axis, -1)
        return torch.movedim(seg_ops.segmented_cumsum(v, f), -1, axis)
    monoid = assoc.segmented(assoc.get(op))
    _, out = reference.scan_ref((flags, values), monoid, axis=axis)
    return out


class DispatchPlan(NamedTuple):
    """Result of the prefix-sum partitioning step (paper §1 use case).

    Attributes:
      counts: (E,) items routed to each bucket (the histogram).
      offsets: (E,) exclusive prefix sum of counts — each bucket's base
        write offset, exactly the paper's "new index values".
      ranks: (T,) position of each item within its bucket.
      dest: (T,) = offsets[bucket_id] + rank — the scatter destination.
    """

    counts: torch.Tensor
    offsets: torch.Tensor
    ranks: torch.Tensor
    dest: torch.Tensor


def _offsets_dtype(total: int) -> torch.dtype:
    """Offset/rank dtype safe for ``total`` dispatched items.

    int32 covers totals below 2**31 (offsets and dest are bounded by the
    item count). Beyond that the scan would silently wrap, so it raises,
    as the reference does with x64 off.
    """
    if total < 2 ** 31:
        return torch.int32
    raise OverflowError(
        f"dispatch over {total} items overflows int32 offsets (the port "
        "keeps the reference's x64-off int32 offsets)")


def exclusive_int_scan(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum of integers along the last axis: the port's
    kernel cumsum on a CUDA tensor, the sequential ``scan_ref`` on the
    CPU — the same bits (see the module doc)."""
    if x.is_cuda:
        from repro_torch.kernels.scan_blocked import ops as kernel_ops
        return kernel_ops.cumsum(x, axis=-1, exclusive=True)
    return reference.scan_ref(x, "sum", axis=-1, exclusive=True)


def dispatch_offsets(expert_ids: torch.Tensor,
                     num_experts: int) -> DispatchPlan:
    """Partitioning offsets for items → buckets via prefix sums.

    ``ranks`` is the exclusive running count of each bucket along the
    item axis: an (E, T) one-hot cumulative sum gathered at each item's
    own bucket. This is the radix-partitioning pattern of the paper's §1
    (Satish et al. / radix join). Peak memory: the one-hot and its
    running counts, 2 · E · T · 4 bytes.

    Args:
      expert_ids: (T,) integer bucket of each item, in [0, E); anything
        else raises (on the card an out-of-range gather would abort the
        process instead).
    """
    dt = _offsets_dtype(expert_ids.shape[0])
    if expert_ids.numel() and not bool(
            (expert_ids.min() >= 0) & (expert_ids.max() < num_experts)):
        raise ValueError(f"bucket ids must lie in [0, {num_experts})")
    buckets = torch.arange(num_experts, device=expert_ids.device)
    onehot = (expert_ids[None, :] == buckets[:, None]).to(dt)  # (E, T)
    # Exclusive scan over items — per-bucket running counts before me.
    running = exclusive_int_scan(onehot)
    ranks = torch.gather(running, 0, expert_ids[None, :].long())[0]
    del running
    counts = onehot.sum(dim=1, dtype=dt)
    offsets = exclusive_int_scan(counts)
    dest = offsets[expert_ids.long()] + ranks
    return DispatchPlan(counts=counts, offsets=offsets, ranks=ranks,
                        dest=dest)


def packed_segment_ids(lengths: torch.Tensor, total: int) -> torch.Tensor:
    """Segment ids for packed sequences from an exclusive length scan.

    Data-pipeline use: given per-document lengths, the exclusive prefix
    sum gives each document's start offset; the segment id of every token
    slot is then the count of starts at-or-before it, minus one.
    """
    starts = exclusive_int_scan(lengths)
    slot = torch.arange(total, device=lengths.device)
    return ((slot[:, None] >= starts[None, :]).sum(dim=1, dtype=torch.int32)
            - 1)
