"""Monoid registrations for the scan engine.

Each of the five kernel families is one of these entries; the kernel
specs live next to their library monoids in
``repro_torch.core.scan.assoc``: the sum, the segmented sum, the affine
recurrence, the compact mask and flash attention's softmax pair (a
config-dependent factory, ``softmax_pair_kernel_spec``; its two backward
specs are factories there too). ``REGISTRY`` is the kernel-side registry
that sweeps and tests iterate over.
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



def softmax_pair(**config) -> assoc.KernelSpec:
    """Flash-attention spec: online softmax + carried value payload.

    Config (scale, masking geometry, block sizes) is baked into the
    per-block input transform — see ``assoc.softmax_pair_kernel_spec``;
    ``scale`` defaults to 1.0.
    """
    config.setdefault("scale", 1.0)
    return assoc.softmax_pair_kernel_spec(**config)


# name -> spec factory taking no arguments (mask gets a default sentinel,
# softmax_pair a default geometry, only meaningful for sweeps and tests;
# real callers pass their padded N / attention config).
REGISTRY = {
    "sum": lambda: SUM,
    "segmented_sum": lambda: SEGMENTED_SUM,
    "affine": lambda: AFFINE,
    "mask": lambda: mask(0x7FFFFFFF),
    "softmax_pair": lambda: softmax_pair(),
}
