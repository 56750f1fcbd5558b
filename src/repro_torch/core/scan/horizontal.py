"""Horizontal scan — the paper's §3.1 log-step network.

The PyTorch counterpart of the reference's ``core/scan/horizontal.py``:
the Hillis–Steele network over the scanned axis, where each step combines
the array with a copy of itself shifted by ``2^k`` (the paper's
``_mm512_alignr_epi32`` + ``_mm512_add_epi32``). ``O(n log n)`` combines,
each a full-width vector op.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.scan import assoc

Pytree = Any


def _shift_down(elems: Pytree, ident_full: Pytree, k: int,
                axis: int) -> Pytree:
    """Shift toward higher indices by ``k``; fill ``[0, k)`` with the
    identity."""

    def f(x, ident):
        head = ident.narrow(axis, 0, k)
        tail = x.narrow(axis, 0, x.shape[axis] - k)
        return torch.cat([head, tail], dim=axis)

    return assoc.tree_map(f, elems, ident_full)


def scan_horizontal(
    elems: Pytree,
    op: "str | assoc.Monoid" = "sum",
    axis: int = -1,
    exclusive: bool = False,
) -> Pytree:
    """Hillis–Steele log-step inclusive scan along ``axis``."""
    monoid = assoc.get(op)
    leaves = assoc.tree_leaves(elems)
    axis = axis % leaves[0].ndim
    n = leaves[0].shape[axis]
    if n == 0:
        return elems

    ident_full = monoid.identity_like(elems)

    out = elems
    k = 1
    while k < n:
        shifted = _shift_down(out, ident_full, k, axis)
        out = monoid.combine(shifted, out)  # shifted = earlier prefix
        k *= 2

    if exclusive:
        out = _shift_down(out, ident_full, 1, axis)
    return out
