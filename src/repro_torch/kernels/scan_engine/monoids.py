"""Monoid registrations for the scan engine.

Each kernel family is one of these entries; the kernel specs live next to
their library monoids in ``repro_torch.core.scan.assoc``: the sum, the
segmented sum, the affine recurrence and the compact mask. The
flash-attention specs are config-dependent factories in ``assoc``
(``softmax_pair_kernel_spec`` and its two backward specs).
"""

from __future__ import annotations

from repro_torch.core.scan import assoc

SUM = assoc.SUM_KERNEL
SEGMENTED_SUM = assoc.SEGMENTED_SUM_KERNEL
AFFINE = assoc.AFFINE_KERNEL


def mask(sentinel: int) -> assoc.KernelSpec:
    """Compact-mask spec: integer mask scan + fused predicate select.

    ``sentinel`` is the destination emitted for dropped lanes (the padded
    row length, so a size-(n+1) scatter buffer parks them harmlessly).
    """
    return assoc.mask_kernel_spec(sentinel)

