"""Affine (SSM-recurrence) scan: the affine registration of the engine."""

from repro_torch.kernels.ssm_scan.ops import (resolved_schedule, ssm_scan,
                                              ssm_scan_decoupled,
                                              ssm_scan_kernel)
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

__all__ = ["resolved_schedule", "ssm_scan", "ssm_scan_decoupled",
           "ssm_scan_kernel", "ssm_scan_ref"]
