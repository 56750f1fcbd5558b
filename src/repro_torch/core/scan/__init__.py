"""Prefix-scan substrate — the paper's contribution as a library (PyTorch).

Algorithm map (paper section → module):
  §3.1 horizontal SIMD  → horizontal.scan_horizontal
  §3.2 vertical SIMD    → vertical.scan_vertical (V1/V2)
  §3.3 tree SIMD        → tree.scan_tree
  §2.1 two-pass threads → blocked.scan_two_pass (variants, dilation)
  §2.2 cache partition  → blocked.scan_blocked, kernels/scan_blocked (CUDA)
  §5   recommendations  → policy.choose

Segmented scans and the partitioning offsets (the paper's §1 use case)
→ segmented. The reference's distributed forms (``scan_sharded``,
``make_sharded_cumsum``: devices as threads) come with a later slice
(ROADMAP).
"""

from repro_torch.core.scan import assoc
from repro_torch.core.scan.api import cumsum, scan
from repro_torch.core.scan.assoc import (AFFINE, MATRIX_AFFINE, MAX, MIN,
                                         PROD, SOFTMAX_PAIR, SUM, Monoid)
from repro_torch.core.scan.blocked import (partition_sizes, scan_blocked,
                                           scan_two_pass)
from repro_torch.core.scan.horizontal import scan_horizontal
from repro_torch.core.scan.policy import Choice, choose
from repro_torch.core.scan.reference import (cumsum_ref, scan_ref,
                                             segmented_scan_ref)
from repro_torch.core.scan.segmented import (DispatchPlan, dispatch_offsets,
                                             packed_segment_ids,
                                             segmented_scan)
from repro_torch.core.scan.tree import scan_tree
from repro_torch.core.scan.vertical import scan_vertical

__all__ = [
    "AFFINE", "MATRIX_AFFINE", "MAX", "MIN", "PROD", "SOFTMAX_PAIR", "SUM",
    "Monoid", "Choice", "DispatchPlan", "choose", "cumsum", "cumsum_ref",
    "dispatch_offsets", "packed_segment_ids", "partition_sizes", "scan",
    "scan_blocked", "scan_horizontal", "scan_ref", "scan_tree",
    "scan_two_pass", "scan_vertical", "segmented_scan", "segmented_scan_ref",
]
