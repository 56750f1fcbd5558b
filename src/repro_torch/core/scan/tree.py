"""Tree scan — the paper's §3.3 (Blelloch two-sweep, work-efficient).

The PyTorch counterpart of the reference's ``core/scan/tree.py``. The
up-sweep builds subtree totals in place; the down-sweep hands exclusive
prefixes back down. ``O(n)`` combines over ``2·log2(n)`` strided passes.
The paper's verdict (Observation 5): work efficiency loses to memory
access efficiency, since the strided gathers and scatters of every level
defeat locality. So this stays a library oracle and a baseline, as in
the paper: it runs on the tensors' device, one PyTorch op per step, and
updates one working copy in place level by level.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.scan import assoc

Pytree = Any


def _strided_get(tree: Pytree, start: int, stride: int) -> Pytree:
    return assoc.tree_map(lambda x: x[start::stride], tree)


def _strided_set(tree: Pytree, start: int, stride: int, val: Pytree) -> None:
    def put(x, v):
        x[start::stride] = v

    assoc.tree_map(put, tree, val)


def scan_tree(
    elems: Pytree,
    op: "str | assoc.Monoid" = "sum",
    axis: int = -1,
    exclusive: bool = False,
) -> Pytree:
    """Blelloch up/down-sweep scan along ``axis``."""
    monoid = assoc.get(op)
    leaves = assoc.tree_leaves(elems)
    axis = axis % leaves[0].ndim
    n = leaves[0].shape[axis]
    if n == 0:
        # The power-of-two pad would round 0 up to 1, with nothing to pad
        # with: the empty scan is its input.
        return elems

    # Work on axis 0, padded to a power of two with identities: one copy,
    # updated in place from here on.
    orig = assoc.tree_map(lambda a: torch.movedim(a, axis, 0), elems)
    pow2 = 1
    while pow2 < n:
        pow2 *= 2
    if pow2 != n:
        ident_full = monoid.identity_like(orig)
        x = assoc.tree_map(lambda a, i: torch.cat([a, i[:pow2 - n]], dim=0),
                           orig, ident_full)
    else:
        x = assoc.tree_map(torch.clone, orig)

    levels = pow2.bit_length() - 1   # log2(pow2)

    # Up-sweep (reduction): parents accumulate left + right subtree totals.
    for d in range(levels):
        stride = 2 ** (d + 1)
        left = _strided_get(x, 2**d - 1, stride)
        right = _strided_get(x, stride - 1, stride)
        _strided_set(x, stride - 1, stride, monoid.combine(left, right))

    # Down-sweep: the root gets the identity; each node passes its value to
    # its left child and (value ∘ old left total) to its right child.
    last = assoc.tree_map(lambda a: a[-1:], x)
    _strided_set(x, pow2 - 1, pow2, monoid.identity_like(last))
    for d in reversed(range(levels)):
        stride = 2 ** (d + 1)
        t = _strided_get(x, 2**d - 1, stride)        # old left totals
        parent = _strided_get(x, stride - 1, stride)
        # the parent's exclusive prefix is EARLIER than the left subtree,
        # so it is the left operand; computed before either store
        right = monoid.combine(parent, t)
        _strided_set(x, 2**d - 1, stride, parent)
        _strided_set(x, stride - 1, stride, right)

    # x now holds the exclusive scan (padded).
    x = assoc.tree_map(lambda a: a[:n], x)
    if not exclusive:
        x = monoid.combine(x, orig)
    return assoc.tree_map(lambda a: torch.movedim(a, 0, axis), x)
