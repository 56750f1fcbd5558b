"""Stable radix partition: histogram + exclusive-cumsum offsets + scatter.

The PyTorch counterpart of the reference's ``relational/partition.py``:
the paper's §1 partitioning step applied to table data. Elements are
binned by a bucket id, each bucket's base write offset is the exclusive
prefix sum of the histogram, and each element's slot within its bucket is
its running per-bucket rank. All of it runs on the scan substrate via
``repro_torch.core.scan.segmented.dispatch_offsets``.
"""

from __future__ import annotations

import torch

from repro_torch.core.scan import segmented as _segmented

# Same fields, relational-facing name: counts (histogram), offsets
# (exclusive scan = bucket base), ranks (within-bucket slot), dest
# (offsets[bucket] + rank — the paper's "new index values").
PartitionPlan = _segmented.DispatchPlan

# Unsigned types torch indexes poorly: their bits move as the signed type
# of the same width.
_SIGNED_VIEW = {torch.uint16: torch.int16, torch.uint32: torch.int32,
                torch.uint64: torch.int64}


def partition_plan(bucket_ids: torch.Tensor,
                   num_buckets: int) -> PartitionPlan:
    """Prefix-sum partitioning plan for (T,) int bucket ids.

    ``plan.dest`` is a stable permutation of [0, T): elements keep their
    input order within each bucket (the property LSD radix sort rests on).
    """
    return _segmented.dispatch_offsets(bucket_ids, num_buckets)


def _scatter(a: torch.Tensor, dest: torch.Tensor) -> torch.Tensor:
    bits = a.view(_SIGNED_VIEW.get(a.dtype, a.dtype))
    out = torch.zeros_like(bits)
    out[dest.long()] = bits
    return out.view(a.dtype)


def apply_plan(plan: PartitionPlan, *arrays: torch.Tensor) -> tuple:
    """Scatter each (T, ...) tensor to its partitioned order via ``dest``."""
    return tuple(_scatter(a, plan.dest) for a in arrays)


def radix_partition(bucket_ids: torch.Tensor, num_buckets: int,
                    *payload: torch.Tensor):
    """Stably reorder data so bucket ``b`` occupies
    ``[offsets[b], offsets[b] + counts[b])``.

    Returns ``(plan, partitioned_ids, *partitioned_payload)``.
    """
    plan = partition_plan(bucket_ids, num_buckets)
    outs = apply_plan(plan, bucket_ids, *payload)
    return (plan,) + outs
