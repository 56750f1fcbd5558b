"""Prefix-scan substrate — the paper's contribution as a library (PyTorch).

Algorithm map (paper section → module):
  §3.1 horizontal SIMD  → horizontal.scan_horizontal
  §2.1 two-pass threads → blocked.scan_two_pass (variants, dilation)
  §2.2 cache partition  → blocked.scan_blocked, kernels/scan_blocked (CUDA)
  §5   recommendations  → policy.choose

Segmented scans and the partitioning offsets (the paper's §1 use case)
→ segmented. The vertical and tree SIMD oracles and the distributed
forms of the reference come with later slices (ROADMAP).
"""

from repro_torch.core.scan import assoc
from repro_torch.core.scan.api import cumsum, scan
from repro_torch.core.scan.assoc import AFFINE, MAX, MIN, PROD, SUM, Monoid
from repro_torch.core.scan.blocked import (partition_sizes, scan_blocked,
                                           scan_two_pass)
from repro_torch.core.scan.horizontal import scan_horizontal
from repro_torch.core.scan.policy import Choice, choose
from repro_torch.core.scan.reference import (cumsum_ref, scan_ref,
                                             segmented_scan_ref)
from repro_torch.core.scan.segmented import (DispatchPlan, dispatch_offsets,
                                             packed_segment_ids,
                                             segmented_scan)

__all__ = [
    "AFFINE", "MAX", "MIN", "PROD", "SUM", "Monoid", "Choice", "DispatchPlan",
    "assoc", "choose", "cumsum", "cumsum_ref", "dispatch_offsets",
    "packed_segment_ids", "partition_sizes", "scan", "scan_blocked",
    "scan_horizontal", "scan_ref", "scan_two_pass", "segmented_scan",
    "segmented_scan_ref",
]
