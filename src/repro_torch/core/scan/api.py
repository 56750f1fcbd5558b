"""Public scan API — single entry point over every algorithm in the package.

    from repro_torch.core import scan
    y = scan.cumsum(x)                      # policy-picked algorithm
    y = scan.scan(x, op="max", algorithm="blocked", block_size=8192)
    y = scan.scan((a, b), op="affine")      # SSM-style affine recurrence

The PyTorch counterpart of the reference's ``core/scan/api.py``, with the
same routing. Work runs on the device of the input: a CUDA tensor with
``algorithm="kernel"`` goes through the CUDA kernels of
``repro_torch.kernels.scan_engine``; a CPU tensor runs their plain
versions. Kernel-backed use is also reachable directly through
``repro_torch.kernels.scan_blocked.ops``.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.scan import assoc
from repro_torch.core.scan import blocked as _blocked
from repro_torch.core.scan import horizontal as _horizontal
from repro_torch.core.scan import policy
from repro_torch.core.scan import reference as _reference
from repro_torch.core.scan import tree as _tree
from repro_torch.core.scan import vertical as _vertical

Pytree = Any

_ALGORITHMS = ("auto", "ref", "horizontal", "vertical", "tree", "blocked",
               "two_pass", "kernel")


def scan(
    elems: Pytree,
    op: "str | assoc.Monoid" = "sum",
    axis: int = -1,
    algorithm: str = "auto",
    exclusive: bool = False,
    **kw,
) -> Pytree:
    """Inclusive (or exclusive) scan of ``elems`` along ``axis``."""
    if algorithm not in _ALGORITHMS:
        raise ValueError(
            f"unknown algorithm {algorithm!r}; one of {_ALGORITHMS}")
    monoid = assoc.get(op)

    if algorithm == "auto":
        leaves = assoc.tree_leaves(elems)
        n = leaves[0].shape[axis]
        batch = max(leaves[0].numel() // max(n, 1), 1)
        itemsize = sum(l.element_size() for l in leaves)
        kernel_ok = monoid.name == "sum" and len(leaves) == 1
        choice = policy.choose(n, itemsize, kernel_available=kernel_ok,
                               batch=batch, cores=policy.cores_of(leaves[0]))
        algorithm = choice.algorithm
        kw.setdefault("block_size", choice.block_size)
        if algorithm == "two_pass":
            kw.setdefault("variant", choice.variant)
        if algorithm == "kernel":
            kw.setdefault("schedule", choice.schedule)

    if algorithm == "kernel":
        from repro_torch.kernels.scan_blocked import ops as kernel_ops

        (x,) = assoc.tree_leaves(elems)
        kw.pop("block_size", None)
        return kernel_ops.cumsum(x, axis=axis, exclusive=exclusive, **kw)
    if algorithm == "ref":
        kw.pop("block_size", None)
        return _reference.scan_ref(elems, monoid, axis, exclusive=exclusive)
    if algorithm == "horizontal":
        kw.pop("block_size", None)
        return _horizontal.scan_horizontal(elems, monoid, axis, exclusive)
    if algorithm == "vertical":
        kw.pop("block_size", None)
        return _vertical.scan_vertical(elems, monoid, axis,
                                       exclusive=exclusive, **kw)
    if algorithm == "tree":
        kw.pop("block_size", None)
        return _tree.scan_tree(elems, monoid, axis, exclusive)
    if algorithm == "blocked":
        return _blocked.scan_blocked(elems, monoid, axis,
                                     exclusive=exclusive, **kw)
    if algorithm == "two_pass":
        if exclusive:
            inc = _blocked.scan_two_pass(elems, monoid, axis, **kw)
            return _shift_exclusive(inc, monoid, axis)
        return _blocked.scan_two_pass(elems, monoid, axis, **kw)
    raise AssertionError(algorithm)


def cumsum(x: torch.Tensor, axis: int = -1, exclusive: bool = False,
           algorithm: str = "auto", **kw) -> torch.Tensor:
    """Prefix sum with the policy-selected algorithm."""
    return scan(x, "sum", axis=axis, algorithm=algorithm,
                exclusive=exclusive, **kw)


def _shift_exclusive(inc: Pytree, monoid: assoc.Monoid, axis: int) -> Pytree:
    if assoc.tree_leaves(inc)[0].shape[axis] == 0:
        return inc  # nothing to shift
    ident_full = monoid.identity_like(inc)
    return assoc.tree_map(
        lambda x, i: torch.cat(
            [i.narrow(axis, 0, 1), x.narrow(axis, 0, x.shape[axis] - 1)],
            dim=axis),
        inc, ident_full)
