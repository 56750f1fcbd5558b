"""Group-by aggregation over the segmented-scan substrate.

The PyTorch counterpart of the reference's ``relational/groupby.py``.
Two shapes of the classic sort-or-partition group-by:

  * ``group_by``        — group ids already dense in [0, G): one stable
    prefix-sum partition brings each group contiguous, segment start
    flags come from the partition offsets, a segmented scan
    (``core.scan.segmented``) folds each run, and the run's last element
    is the aggregate (identity for empty groups).
  * ``group_by_sorted`` — keys pre-sorted but arbitrary-valued: segment
    boundaries are key changes, aggregates sit at segment ends, and the
    (unique key, aggregate) pairs are packed with ``filter_compact`` —
    compaction and group-by from the same scan toolbox.
"""

from __future__ import annotations

import torch

from repro_torch.core.scan import assoc
from repro_torch.core.scan import policy
from repro_torch.core.scan import segmented as _segmented
from repro_torch.relational.compact import filter_compact
from repro_torch.relational.partition import apply_plan, partition_plan

_AGGS = ("sum", "prod", "max", "min", "count", "mean")
_ALGORITHMS = ("auto", "ref", "kernel")


def _seg_algorithm(algorithm: str, op: str, n: int, itemsize: int,
                   on_cuda: bool = False) -> str:
    """Resolve the segmented-scan backend for a length-``n`` run.

    ``auto`` routes long runs onto the segmented-sum kernels — gated by
    the SAME policy threshold that picks the kernel algorithm for plain
    scans (``policy.choose``: bandwidth-bound sizes past the block
    budget) — and only for a CUDA tensor (``on_cuda``), where the
    reference gates on a TPU; on the CPU the kernel route would run the
    plain version of each kernel, so the library scan is the default. The
    kernel path covers the sum monoid (which ``mean`` reduces to); other
    aggregates stay on the library scan, a Python loop over the run that
    only suits small sizes.
    """
    if algorithm not in _ALGORITHMS:
        raise ValueError(
            f"unknown algorithm {algorithm!r}; one of {_ALGORITHMS}")
    if algorithm != "auto":
        return algorithm
    if op != "sum" or not on_cuda:
        return "ref"
    choice = policy.choose(n, itemsize, kernel_available=True)
    return "kernel" if choice.algorithm == "kernel" else "ref"


def _identity_result(agg: str, shape, dtype, device):
    if agg == "count":
        return torch.zeros(shape, dtype=torch.int32, device=device)
    base = torch.zeros(shape, dtype=dtype, device=device)
    if agg in ("sum", "mean"):
        return base
    return assoc.get(agg).identity_like(base)


def group_by(group_ids: torch.Tensor, values: torch.Tensor, num_groups: int,
             agg: str = "sum", algorithm: str = "auto") -> torch.Tensor:
    """Per-group aggregate of (T, ...) ``values`` by (T,) dense ids.

    Returns a (num_groups, ...) tensor; empty groups hold the aggregate's
    identity (0 for sum/mean/count, the monoid identity otherwise) —
    ``group_by(ids, v, G, "sum")`` equals a segment sum bit-exactly for
    integer values.

    ``algorithm`` picks the segmented-scan backend: ``"ref"`` (library
    scan), ``"kernel"`` (the segmented-sum kernels), or ``"auto"`` —
    kernel for long runs past the policy's bandwidth-bound threshold on
    a CUDA tensor (see ``_seg_algorithm``).
    """
    if agg not in _AGGS:
        raise ValueError(f"unknown agg {agg!r}; one of {_AGGS}")
    T = group_ids.shape[0]
    dev = values.device
    if agg == "count":  # (num_groups,) regardless of value dims
        if T == 0:
            return torch.zeros((num_groups,), dtype=torch.int32, device=dev)
        return partition_plan(group_ids, num_groups).counts.to(torch.int32)
    out_shape = (num_groups,) + tuple(values.shape[1:])
    if T == 0:
        return _identity_result(agg, out_shape, values.dtype, dev)

    plan = partition_plan(group_ids, num_groups)
    (sv,) = apply_plan(plan, values)
    # Segment start flags from the partition offsets: every non-empty
    # group's base offset begins a run (empty groups collapse onto the
    # next group's offset — all write 1, no phantom runs).
    flags = torch.zeros((T + 1,), dtype=torch.int32, device=dev)
    flags[plan.offsets.long()] = 1
    flags = flags[:T]
    op = "sum" if agg == "mean" else agg
    algo = _seg_algorithm(algorithm, op, T, values.element_size(),
                          values.is_cuda)
    if algo == "kernel":
        # Broadcast the (T,) flags over trailing value dims: the kernel
        # wrapper flattens leading axes into rows of the (rows, T) grid.
        kflags = flags.reshape((T,) + (1,) * (sv.ndim - 1)).expand(sv.shape)
        seg = _segmented.segmented_scan(sv, kflags, op=op, axis=0,
                                        algorithm="kernel")
    else:
        seg = _segmented.segmented_scan(sv, flags, op=op, axis=0)
    ends = torch.clamp(plan.offsets + plan.counts - 1, 0, T - 1)
    gathered = seg[ends.long()]  # (G, ...) — last element of each run
    nonempty = (plan.counts > 0).reshape(
        (num_groups,) + (1,) * (gathered.ndim - 1))
    ident = _identity_result(agg, out_shape, values.dtype, dev)
    out = torch.where(nonempty, gathered, ident)
    if agg == "mean":
        denom = torch.clamp(plan.counts, min=1).reshape(nonempty.shape)
        rdt = out.dtype if out.is_floating_point() else torch.float32
        out = out.to(rdt) / denom.to(rdt)
    return out


def group_by_sorted(keys: torch.Tensor, values: torch.Tensor,
                    agg: str = "sum"
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Aggregate runs of equal ``keys`` (pre-sorted, any values).

    Returns ``(unique_keys, aggregates, num_groups)`` — fixed-size (T,)
    buffers whose first ``num_groups`` rows are live, packed via
    ``filter_compact`` on the segment-end mask.
    """
    if agg not in _AGGS:
        raise ValueError(f"unknown agg {agg!r}; one of {_AGGS}")
    T = keys.shape[0]
    if T == 0:
        return keys, values, torch.zeros((), dtype=torch.int32,
                                         device=keys.device)

    one = torch.ones((1,), dtype=torch.int32, device=keys.device)
    starts = torch.cat([one, (keys[1:] != keys[:-1]).to(torch.int32)])
    ends_mask = torch.cat([starts[1:] != 0, one.bool()])
    ones = torch.ones((T,), dtype=torch.int32, device=keys.device)
    if agg == "count":
        seg = _segmented.segmented_scan(ones, starts, op="sum", axis=0)
    elif agg == "mean":
        seg = _segmented.segmented_scan(values, starts, op="sum", axis=0)
        cnt = _segmented.segmented_scan(ones, starts, op="sum", axis=0)
        seg = seg / cnt.to(seg.dtype)
    else:
        seg = _segmented.segmented_scan(values, starts, op=agg, axis=0)
    uniq, count = filter_compact(keys, ends_mask)
    aggs, _ = filter_compact(seg, ends_mask)
    return uniq, aggs, count
