"""Vertical scan — the paper's §3.2.

The PyTorch counterpart of the reference's ``core/scan/vertical.py``.
The paper divides the data into ``w`` chunks of length ``k = n/w``; lane
``i`` of the SIMD register walks chunk ``i`` sequentially, through
gather/scatter at stride ``k``. Work-efficient (``O(n)`` combines), two
passes:

  * V1: pass 1 writes each chunk's local prefix scan, pass 2 combines the
    exclusive scan of the chunk totals into it.
  * V2: pass 1 only folds each chunk to its total (no writes), pass 2
    scans each chunk again with its offset as the starting carry.

As in the reference, the strided gather is a reshape to ``(lanes, k)``
(chunk ``i`` is row ``i``) and "lane ``i`` walks its chunk" is a loop
down the columns, vectorized across the rows. A library oracle, as in
the paper (Observation 5): it runs on the tensors' device, one PyTorch
op per step.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.scan import assoc
from repro_torch.core.scan import reference

Pytree = Any


def scan_vertical(
    elems: Pytree,
    op: "str | assoc.Monoid" = "sum",
    axis: int = -1,
    lanes: int = 16,
    variant: int = 2,
    exclusive: bool = False,
) -> Pytree:
    """Two-pass vertical scan with ``lanes`` parallel chunks.

    Args:
      variant: 1 → local scans in pass 1 (the paper's SIMD-V1);
               2 → totals only in pass 1, the scan in pass 2 (SIMD-V2).
    """
    if variant not in (1, 2):
        raise ValueError("variant must be 1 or 2")
    monoid = assoc.get(op)
    leaves = assoc.tree_leaves(elems)
    axis = axis % leaves[0].ndim
    n = leaves[0].shape[axis]
    if n == 0:
        # Nothing to scan: padding would blow the axis up to ``lanes``
        # identities, and variant 2 would fold an empty chunk.
        return elems

    if n % lanes != 0:
        # Pad the tail with identity elements; slice the result back.
        padded_n = -(-n // lanes) * lanes
        ident_full = monoid.identity_like(elems)

        def pad(x, i):
            shape = list(x.shape)
            shape[axis] = padded_n - n
            return torch.cat([x, i.narrow(axis, 0, 1).expand(shape)],
                             dim=axis)

        out = scan_vertical(assoc.tree_map(pad, elems, ident_full), monoid,
                            axis, lanes, variant, exclusive)
        return assoc.tree_map(lambda x: x.narrow(axis, 0, n), out)

    k = n // lanes

    def to_grid(x):
        x = torch.movedim(x, axis, 0)
        return x.reshape((lanes, k) + tuple(x.shape[1:]))

    def from_grid(x):
        return torch.movedim(x.reshape((n,) + tuple(x.shape[2:])), 0, axis)

    grid = assoc.tree_map(to_grid, elems)   # leaves: (lanes, k, ...)

    if variant == 1:
        # Pass 1: each chunk's local scan (the paper's scatter-writes).
        local = reference.scan_ref(grid, monoid, axis=1)
        totals = assoc.tree_map(lambda x: x[:, -1], local)
        # The exclusive scan of the small array of chunk totals.
        offsets = reference.scan_ref(totals, monoid, axis=0, exclusive=True)
        # Pass 2: combine the offsets into the stored local scans.
        out = monoid.combine(assoc.tree_map(lambda o: o[:, None], offsets),
                             local)
        # combine() may have broadcast the (lanes, 1, ...) offset.
        out = assoc.tree_map(lambda o, l: o.expand(l.shape), out, local)
    else:
        # Pass 1: reduce only, no writes (the paper's bandwidth saving).
        totals = monoid.fold(grid, axis=1)
        offsets = reference.scan_ref(totals, monoid, axis=0, exclusive=True)
        # Pass 2: a left fold down each chunk from the chunk's offset, all
        # chunks at once (the reference's lax.scan under vmap).
        carry, steps = offsets, []
        for j in range(k):
            carry = monoid.combine(carry,
                                   assoc.tree_map(lambda x: x[:, j], grid))
            steps.append(carry)
        out = assoc.tree_map(lambda *xs: torch.stack(xs, dim=1), *steps)

    result = assoc.tree_map(from_grid, out)
    if exclusive:
        result = _exclusive_from_inclusive(result, monoid, axis)
    return result


def _exclusive_from_inclusive(inc: Pytree, monoid: assoc.Monoid, axis: int):
    ident_full = monoid.identity_like(inc)
    return assoc.tree_map(
        lambda x, i: torch.cat([i.narrow(axis, 0, 1),
                                x.narrow(axis, 0, x.shape[axis] - 1)],
                               dim=axis),
        inc, ident_full)
