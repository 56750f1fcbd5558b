"""Pure sequential reference scans — the semantic ground truth.

The PyTorch counterpart of the reference's ``core/scan/reference.py``:
one sequential left-to-right pass of the associative operator (the
paper's ``Scalar`` baseline), so float32 results carry no
reassociation. A Python loop over the scanned axis, for checks at small
sizes.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.scan import assoc

Pytree = Any


def scan_ref(
    elems: Pytree,
    op: "str | assoc.Monoid" = "sum",
    axis: int = -1,
    exclusive: bool = False,
    reverse: bool = False,
) -> Pytree:
    """Sequential inclusive (or exclusive) scan along ``axis``.

    For ``exclusive=True`` the output at position ``i`` is the fold of
    elements ``[0, i)`` with the identity at position 0.
    """
    monoid = assoc.get(op)
    elems = assoc.tree_map(lambda x: torch.movedim(x, axis, 0), elems)
    n = assoc.tree_leaves(elems)[0].shape[0]
    if n == 0:
        # A length-0 scan is its (empty) input.
        return assoc.tree_map(lambda x: torch.movedim(x, 0, axis), elems)
    if reverse:
        elems = assoc.tree_map(lambda x: torch.flip(x, (0,)), elems)
    carry = monoid.identity_like(assoc.tree_map(lambda x: x[0], elems))
    outs = []
    for i in range(n):
        new = monoid.combine(carry, assoc.tree_map(lambda x: x[i], elems))
        outs.append(carry if exclusive else new)
        carry = new
    ys = assoc.tree_map(lambda *xs: torch.stack(xs), *outs)
    if reverse:
        ys = assoc.tree_map(lambda x: torch.flip(x, (0,)), ys)
    return assoc.tree_map(lambda x: torch.movedim(x, 0, axis), ys)


def cumsum_ref(x: torch.Tensor, axis: int = -1,
               exclusive: bool = False) -> torch.Tensor:
    """Prefix sum oracle, accumulating in the shared accumulation dtype
    (``assoc.accum_dtype``) and cast back to ``x``'s dtype."""
    acc = assoc.accum_dtype(x.dtype)
    out = scan_ref(x.to(acc), "sum", axis=axis, exclusive=exclusive)
    return out.to(x.dtype)


def segmented_scan_ref(
    values: Pytree,
    flags: torch.Tensor,
    op: "str | assoc.Monoid" = "sum",
    axis: int = -1,
) -> Pytree:
    """Segmented inclusive scan: restart at every nonzero flag."""
    monoid = assoc.segmented(assoc.get(op))
    _, out = scan_ref((flags, values), monoid, axis=axis)
    return out
