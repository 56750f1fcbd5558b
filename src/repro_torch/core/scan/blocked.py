"""Cache-friendly partitioned scan — the paper's §2.2.

The PyTorch counterpart of the reference's ``core/scan/blocked.py``:

``scan_blocked``
    The partitioned ("-P") algorithm: data is cut into blocks; BOTH
    passes over a block happen while it is resident, and a running carry
    links consecutive blocks — one pass over the data in memory-traffic
    terms (the scan engine's carry schedule is the explicitly tiled
    version of this same organization).

``scan_two_pass``
    The NON-partitioned baseline (paper Fig. 1a–d): pass 1 over all
    data, then pass 2 over all data. Variant 1 (Fig 1a/1c) scans first
    and increments second; variant 2 (Fig 1b/1d) accumulates totals
    first and scans with the offset second. Supports the paper's
    dilation factor ``d`` (partition 0 shrunk to ``d × B``).
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from repro_torch.core.scan import assoc
from repro_torch.core.scan import horizontal
from repro_torch.core.scan import reference

Pytree = Any


def _axis_first(tree: Pytree, axis: int) -> Pytree:
    return assoc.tree_map(lambda x: torch.movedim(x, axis, 0), tree)


def _axis_back(tree: Pytree, axis: int) -> Pytree:
    return assoc.tree_map(lambda x: torch.movedim(x, 0, axis), tree)


def _pad_to(tree: Pytree, monoid: assoc.Monoid, n: int,
            target: int) -> Pytree:
    if target == n:
        return tree
    ident_full = monoid.identity_like(tree)
    return assoc.tree_map(
        lambda x, i: torch.cat(
            [x, i[:1].expand((target - n,) + tuple(i.shape[1:]))], dim=0),
        tree, ident_full)


def _inner_scan(block: Pytree, monoid: assoc.Monoid, inner: str) -> Pytree:
    if inner == "horizontal":
        return horizontal.scan_horizontal(block, monoid, axis=0)
    if inner == "ref":
        return reference.scan_ref(block, monoid, axis=0)
    raise ValueError(f"unknown inner scan {inner!r}")


def scan_blocked(
    elems: Pytree,
    op: "str | assoc.Monoid" = "sum",
    axis: int = -1,
    block_size: int = 4096,
    inner: str = "horizontal",
    exclusive: bool = False,
) -> Pytree:
    """Partitioned scan with a carried running total (paper §2.2).

    The carry is the prior blocks' fold — "the total sum from the
    previous partition". Within a block the inclusive scan uses the
    horizontal (in-register) algorithm.
    """
    monoid = assoc.get(op)
    leaves = assoc.tree_leaves(elems)
    axis = axis % leaves[0].ndim
    n = leaves[0].shape[axis]
    if n == 0:
        return elems

    x = _axis_first(elems, axis)
    num_blocks = -(-n // block_size)
    padded = num_blocks * block_size
    x = _pad_to(x, monoid, n, padded)
    x = assoc.tree_map(
        lambda a: a.reshape((num_blocks, block_size) + tuple(a.shape[1:])), x)

    carry = monoid.identity_like(assoc.tree_map(lambda a: a[0, 0], x))
    blocks_out = []
    for j in range(num_blocks):
        local = _inner_scan(assoc.tree_map(lambda a: a[j], x), monoid, inner)
        # Both "passes" over this block happen here, while it is resident:
        # pass 1 = the in-block scan, pass 2 = the carry combine.
        out = monoid.combine(assoc.tree_map(lambda c: c[None], carry), local)
        out = assoc.tree_map(lambda o, l: o.expand(l.shape), out, local)
        carry = assoc.tree_map(lambda o: o[-1], out)
        blocks_out.append(out)
    out = assoc.tree_map(
        lambda *bs: torch.cat(bs, dim=0)[:n], *blocks_out)
    if exclusive:
        ident_full = monoid.identity_like(out)
        out = assoc.tree_map(
            lambda o, i: torch.cat([i[:1], o[:-1]], dim=0), out, ident_full)
    return _axis_back(out, axis)


def partition_sizes(
    n: int, num_partitions: int, dilation: float = 1.0
) -> list[int]:
    """Split ``n`` into partitions, partition 0 scaled by ``dilation``.

    ``dilation=1`` → equal sizes; ``dilation=0`` → partition 0 vanishes
    (Fig 1a/1b are the d=0 special cases of Fig 1c/1d).
    """
    if not 0.0 <= dilation <= 1.0:
        raise ValueError("dilation must be in [0, 1]")
    denom = dilation + (num_partitions - 1)
    first = int(round(n * dilation / denom)) if denom else 0
    rest = num_partitions - 1
    base = (n - first) // rest if rest else 0
    sizes = [first] + [base] * rest
    sizes[-1] += n - sum(sizes)
    return [s for s in sizes if s > 0] or [n]


def scan_two_pass(
    elems: Pytree,
    op: "str | assoc.Monoid" = "sum",
    axis: int = -1,
    num_partitions: int = 8,
    variant: int = 2,
    dilation: float = 1.0,
    sizes: "Sequence[int] | None" = None,
) -> Pytree:
    """Unfused two-full-pass scan (paper Fig. 1) — the baseline to beat."""
    if variant not in (1, 2):
        raise ValueError("variant must be 1 or 2")
    monoid = assoc.get(op)
    leaves = assoc.tree_leaves(elems)
    axis = axis % leaves[0].ndim
    n = leaves[0].shape[axis]
    if n == 0:
        return elems
    if sizes is None:
        sizes = partition_sizes(n, num_partitions, dilation)
    if sum(sizes) != n:
        raise ValueError("partition sizes must sum to the axis length")

    x = _axis_first(elems, axis)
    parts, lo = [], 0
    for s in sizes:
        parts.append(assoc.tree_map(lambda a: a[lo:lo + s], x))
        lo += s

    def offset_into(off, loc):
        out = monoid.combine(assoc.tree_map(lambda c: c[None], off), loc)
        return assoc.tree_map(lambda o, l: o.expand(l.shape), out, loc)

    if variant == 1:
        # Pass 1: local prefix sums (writes the whole array once).
        locals_ = [horizontal.scan_horizontal(p, monoid, axis=0)
                   for p in parts]
        totals = [assoc.tree_map(lambda a: a[-1], l) for l in locals_]
        offsets = _exclusive_offsets(totals, monoid)
        # Pass 2: increment every element (reads + writes it again).
        out_parts = [offset_into(off, loc)
                     for off, loc in zip(offsets, locals_)]
    else:
        # Pass 1: accumulate totals only (reads, NO writes — Fig 1b).
        totals = [monoid.fold(p, axis=0) for p in parts]
        offsets = _exclusive_offsets(totals, monoid)
        # Pass 2: scan with the offset folded in.
        out_parts = [
            offset_into(off, horizontal.scan_horizontal(p, monoid, axis=0))
            for off, p in zip(offsets, parts)]

    out = assoc.tree_map(lambda *xs: torch.cat(xs, dim=0), *out_parts)
    return _axis_back(out, axis)


def _exclusive_offsets(totals: list, monoid: assoc.Monoid) -> list:
    """Exclusive folds of the per-partition totals (the `sums` array)."""
    offsets = [monoid.identity_like(totals[0])]
    acc = totals[0]
    for t in totals[1:]:
        offsets.append(acc)
        acc = monoid.combine(acc, t)
    return offsets
