"""Relational operators where every data movement is a prefix sum.

The PyTorch counterpart of the reference's ``relational`` package. The
source paper motivates prefix sums as "a building block of many important
operators including join, sort and filter queries"; this package is that
claim as a library, layered on ``repro_torch.core.scan``:

  compact.py    filter / stream compaction — mask cumsum -> gather
                (the mask-compact CUDA kernels of ``kernels.compact``)
  partition.py  stable radix partition — histogram + exclusive-cumsum
                offsets (``core.scan.segmented.dispatch_offsets``)
  sort.py       LSD radix sort — composed partition passes
  groupby.py    group-by aggregate — partition + segmented scan (the
                segmented-sum CUDA kernels of ``kernels.segscan``)
  join.py       partitioned equi-join — scan-built build/probe offsets

Operators run on the device of their input; where the reference picks a
kernel route on a TPU, the port picks it for a CUDA tensor.
"""

from repro_torch.relational.compact import (compact_indices, filter_compact,
                                            mask_ranks)
from repro_torch.relational.groupby import group_by, group_by_sorted
from repro_torch.relational.join import (JoinResult, estimate_max_matches,
                                         hash_join)
from repro_torch.relational.partition import (PartitionPlan, partition_plan,
                                              radix_partition)
from repro_torch.relational.sort import argsort, radix_sort

__all__ = [
    "JoinResult", "PartitionPlan", "argsort", "compact_indices",
    "estimate_max_matches",
    "filter_compact", "group_by", "group_by_sorted", "hash_join",
    "mask_ranks", "partition_plan", "radix_partition", "radix_sort",
]
