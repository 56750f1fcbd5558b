"""Blocked prefix sum: the sum registration of the scan engine."""

from repro_torch.kernels.scan_blocked.ops import (cumsum, scan_blocked_decoupled,
                                                  scan_blocked_kernel)
from repro_torch.kernels.scan_blocked.ref import cumsum_ref

__all__ = ["cumsum", "cumsum_ref", "scan_blocked_decoupled",
           "scan_blocked_kernel"]
